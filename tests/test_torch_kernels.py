"""The port's kernels against the reference's Pallas kernels.

Every case makes its inputs with numpy from a seed, hands identical bf16
values to ``repro.kernels.ops`` (Pallas in interpret mode off TPU) and to
``repro_torch.kernels.ops`` (the plain PyTorch version, since the tensors lie
on the CPU), and compares. The ``gpu``-marked tests hold each CUDA kernel
against its plain version and skip where there is no card; they need
neither JAX nor the reference package, which the other tests import through
the ``ref`` fixture, so ``-m gpu`` runs on a machine without JAX.
"""
import importlib.util
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import _build
from repro_torch.kernels import bcsc_matmul as pbm
from repro_torch.kernels import bcsc_mlp as pmlp
from repro_torch.kernels import epilogue as pepi
from repro_torch.kernels import flash_backward as pfb
from repro_torch.kernels import local_attention as pswa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import paged_attention as ppa
from repro_torch.kernels import rs_matmul as prs
from repro_torch.models import layers as players
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


@pytest.mark.parametrize("M", [4, 16])
def test_bcsc_mlp_packed_ungated_gelu(ref, M):
    """The ungated MLP (musicgen: tanh-gelu(x · w1) · w2, no second up
    projection) against the Pallas kernel in interpret mode, at the decode
    rows of a musicgen pass (4) and a short prefill (16). The hidden is
    rounded to bf16 in both: 2e-3 of max |out|, as for the gated MLP."""
    rng = np.random.default_rng(20 + M)
    w1, p1 = _packed_pair(ref, 64, 256, 0.75, seed=M)
    w2, p2 = _packed_pair(ref, 256, 64, 0.75, seed=M + 1)
    x = _bf16(rng, (M, 64))
    jnp = ref.jnp
    want = np.asarray(ref.ops.bcsc_mlp_packed(
        jnp.asarray(x, jnp.bfloat16), w1, None, w2, d_ff=256, n_out=64,
        activation="gelu"))
    got = pops.bcsc_mlp_packed(torch.from_numpy(x).bfloat16(), p1, None, p2,
                               d_ff=256, n_out=64, plan=_plan(ref),
                               activation="gelu")
    assert got.shape == (M, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


# ------------------------------------------------------- the GEMM's walk
def _pack_with_empty_cols(K, N, sparsity, seed, empty, device="cpu"):
    """A port pack whose block-columns ``empty`` hold no block at all (not
    even the explicit zero block ``pack_weight`` puts there), padded past
    its real count with blocks that repeat the last (row, col)."""
    from repro_torch.core import sparsity as sp
    g = torch.Generator().manual_seed(seed)
    w = sp.block_magnitude_prune(torch.randn(K, N, generator=g) / K ** 0.5,
                                 sparsity, 16, 16)
    for c in empty:
        w[:, 16 * c:16 * (c + 1)] = 0
    m = sp.bcsc_encode(w, 16, 16)
    packed = {"blocks": m.blocks.bfloat16(), "row_ids": m.row_ids,
              "col_ids": pbm.expand_col_ptr(m.col_ptr), "col_ptr": m.col_ptr,
              "nnzb": torch.tensor(m.blocks.shape[0], dtype=torch.int32)}
    packed = psparse.pad_packed(packed, m.blocks.shape[0] + 5)
    return {k: v.to(device) for k, v in packed.items()}


def _gemm_walk_model(x, blocks, row_ids, col_ptr, n_out, bm, split):
    """The GEMM walk of csrc/bcsc_matmul.cu in plain torch, fp32.

    Tile (column group g of GEMM_GROUP block-columns, m-tile of bm rows, K
    split z of ``split_rows`` block-rows): per chunk of GEMM_CHUNK
    block-rows, index each (row, column) of the group's segments by the
    first block of its run of equal rows, walk in ascending order the
    k-tiles (GEMM_TILE_ROWS block-rows) in which the group holds an indexed
    block, stage each one's x tile once and multiply every present block
    with its 16 columns.
    Split 0's partial then takes the others in split order. Returns (out,
    tiles, reads): x tiles staged per (g, m-tile, z), and how often each
    payload block was staged."""
    M, K = x.shape
    NB, KB, G = n_out // 16, K // 16, pbm.GEMM_GROUP
    T = pbm.GEMM_TILE_ROWS
    rows = pbm.split_rows(K, split)
    cp, rid = col_ptr.tolist(), row_ids.tolist()
    xf, bf = x.float(), blocks.float()
    parts = [torch.zeros(M, n_out) for _ in range(split)]
    staged, reads = {}, [0] * len(rid)

    def index(g, r0, r1):
        """{(row, column in group): first block of the run}."""
        seg = [cp[min(g * G + j, NB)] for j in range(G + 1)]
        tab = {}
        for i in range(seg[0], seg[G]):
            row = rid[i]
            if not r0 <= row < r1:
                continue
            j = max(jj for jj in range(G) if seg[jj] <= i)
            if i > seg[j] and rid[i - 1] == row:
                continue                  # a repeat (a pad)
            tab[(row, j)] = i
        return tab

    for g in range(-(-NB // G)):
        for z in range(split):
            lo, hi = z * rows, min(KB, (z + 1) * rows)
            for mt in range(-(-M // bm)):
                staged[(g, mt, z)] = 0
            for r0 in range(lo, hi, pbm.GEMM_CHUNK):
                r1 = min(r0 + pbm.GEMM_CHUNK, hi)
                tab = index(g, r0, r1)
                walk = sorted({row // T for row, _ in tab})
                for mt in range(-(-M // bm)):
                    m0 = mt * bm
                    staged[(g, mt, z)] += len(walk)
                    for t in walk:
                        for row in range(T * t, T * (t + 1)):
                            strip = xf[m0:m0 + bm, 16 * row:16 * (row + 1)]
                            for j in range(G):
                                i = tab.get((row, j))
                                if i is None:
                                    continue
                                reads[i] += 1
                                c = g * G + j
                                parts[z][m0:m0 + bm, 16 * c:16 * (c + 1)] \
                                    += strip @ bf[i]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out, staged, reads


GEMM_WALK_CASES = {    # M, K, N, how the pack is made
    "M 16": (16, 256, 512, "port"),
    "M 48, N / 16 odd": (48, 256, 528, "port"),
    "padded pack": (80, 512, 256, "padded"),
    "empty columns": (48, 256, 528, "empty"),
    "K past one chunk": (16, 8448, 32, "port"),
}


def _walk_case(name, device="cpu"):
    M, K, N, how = GEMM_WALK_CASES[name]
    seed = len(name)
    if how == "empty":
        pack = _pack_with_empty_cols(K, N, 0.6, seed, (0, 7, 32), device)
    else:
        pack = _port_pack(K, N, 0.75 if how == "port" else 0.6, seed, device)
        if how == "padded":
            pack = psparse.pad_packed(pack, pack["blocks"].shape[0] + 21)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(M, K, generator=g).bfloat16().to(device)
    return x, pack, N


@pytest.mark.parametrize("case", sorted(GEMM_WALK_CASES))
@pytest.mark.parametrize("bm,split", [(64, 1), (128, 1), (128, 3)])
def test_gemm_walk_model_matches_plain(case, bm, split):
    """The kernel's walk (column groups, the merged block-row union, first-
    of-run indexing that lets no zero pad displace the real block, empty
    columns, edge rows and columns, a K split combined in order) computes
    the plain product: fp32 sums of the same bf16 products in another
    order, 1e-5 of max |out|."""
    x, p, N = _walk_case(case)
    got, _, _ = _gemm_walk_model(x, p["blocks"], p["row_ids"], p["col_ptr"],
                                 N, bm, split)
    want = pbm.bcsc_matmul_plain(x, p["blocks"], p["row_ids"], p["col_ids"],
                                 n_out=N)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", sorted(GEMM_WALK_CASES))
def test_gemm_walk_stages_each_strip_and_block_once_per_tile(case):
    """Structural count of the walk at the planner's plan on an H100: each
    tile stages one x tile per k-tile in which its group holds a block
    within its split (the union of its columns' block-rows, in k-tiles),
    and each real block once per m-tile, ceil(M / bm) times, while its
    repeats (the pads) are never staged."""
    x, p, N = _walk_case(case)
    M, K = x.shape
    bm, split = pbm.gemm_plan(M, K, N, H100_SMS)
    _, staged, reads = _gemm_walk_model(x, p["blocks"], p["row_ids"],
                                        p["col_ptr"], N, bm, split)
    G, KB, rows = pbm.GEMM_GROUP, K // 16, pbm.split_rows(K, split)
    NB = N // 16
    cp, rid = p["col_ptr"].tolist(), p["row_ids"].tolist()
    for (g, mt, z), n in staged.items():
        lo, hi = cp[g * G], cp[min((g + 1) * G, NB)]
        union = {r // pbm.GEMM_TILE_ROWS for r in rid[lo:hi]
                 if z * rows <= r < min(KB, (z + 1) * rows)}
        assert n == len(union)
    cols = pbm.expand_col_ptr(p["col_ptr"]).tolist()
    for i, n in enumerate(reads):
        repeat = i > 0 and cols[i - 1] == cols[i] and rid[i - 1] == rid[i]
        assert n == (0 if repeat else -(-M // bm))
    assert len(staged) == (-(-NB // G)) * (-(-M // bm)) * split


@pytest.mark.parametrize("M,K,N,plan", [
    (512, 2048, 11008, (128, 1)),     # qwen2.5-3b up/gate at M 512
    (512, 11008, 2048, (128, 4)),     # qwen2.5-3b down: 32 tiles, split 4
    (8192, 2304, 9216, (128, 1)),     # gemma2-2b up/gate, one 8192 prompt
    (8192, 9216, 2304, (128, 1)),     # gemma2-2b down
    (128, 2048, 11008, (128, 2)),     # qwen2.5-3b, the shortest GEMM tier
    (16, 256, 512, (64, 1)),          # too little K to split
    (16, 4096, 256, (64, 8)),
])
def test_gemm_plan_at_served_shapes(M, K, N, plan):
    """The planner's choices on an H100 (132 SMs): 128-row tiles past
    M 64, K split only while the grid stays within one wave and each split
    keeps MIN_SPLIT_ROWS block-rows."""
    bm, split = pbm.gemm_plan(M, K, N, H100_SMS)
    assert (bm, split) == plan
    tiles = -(-M // bm) * -(-(N // 16) // pbm.GEMM_GROUP)
    assert split == 1 or tiles * split <= H100_SMS
    assert (K // 16) // split >= min(pbm.MIN_SPLIT_ROWS, K // 16)


# ---------------------------------------------------- the fused MLP's schedule
CSRC = pathlib.Path(_build.__file__).resolve().with_name("csrc")


def _mlp_packs(K, d_ff, n_out, gated, seed, device="cpu"):
    """gate [, up], down packs (pads past the real counts, an empty hidden
    block-column and an empty output block-column) and their counts."""
    gate = _pack_with_empty_cols(K, d_ff, 0.6, seed, (1,), device)
    up = _pack_with_empty_cols(K, d_ff, 0.6, seed + 1, (), device) \
        if gated else None
    down = _pack_with_empty_cols(d_ff, n_out, 0.6, seed + 2, (0,), device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    counts = torch.stack([gate["nnzb"], up["nnzb"] if gated else zero,
                          down["nnzb"]]).to(torch.int32)
    return gate, up, down, counts


def _trip(p, key):
    return None if p is None else (p["blocks"], p["row_ids"], p[key])


@pytest.mark.parametrize("Mp", [8, 16, 64])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_mlp_schedule_model_matches_plain(Mp, gated, n_sm):
    """The kernel's schedule (pairs of warps owning hidden columns, each
    column's blocks cut in halves; the down projection's segments cut into
    mlp_plan's split, partials added in split order) computes the plain
    MLP over packs with pads past their counts and empty columns, on a
    one-SM grid (pairs own several columns, split 2) and an H100's. The
    hidden is rounded to bf16 in both, and an fp32 sum in another order
    can flip one such rounding: 2e-3 of max |out|."""
    K, d_ff, n_out = 64, 256, 64
    gate, up, down, counts = _mlp_packs(K, d_ff, n_out, gated, Mp)
    x = torch.randn(Mp, K, generator=torch.Generator().manual_seed(Mp)
                    ).bfloat16()
    got, _ = pmlp.schedule_model(
        x, _trip(gate, "col_ptr"), _trip(up, "col_ptr"),
        _trip(down, "col_ptr"), counts, d_ff=d_ff, n_out=n_out,
        activation="silu", n_sm=n_sm)
    want = pmlp.bcsc_mlp_plain(
        x, _trip(gate, "col_ids"), _trip(up, "col_ids"),
        _trip(down, "col_ids"), counts, d_ff=d_ff, n_out=n_out,
        activation="silu")
    if n_sm == 1:
        assert pmlp.mlp_plan(d_ff, n_out, n_sm)["split"] == 2
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


@pytest.mark.parametrize("Mp", [8, 16, 24, 32, 64])
def test_mlp_schedule_reads_each_real_block_once(Mp):
    """Structural count of the schedule: every real block of the three packs
    is read exactly once per call at every Mp <= 64 (its x or hidden slice
    feeds all Mp / 8 products of its A fragment), pads never; every hidden
    column has one owner pair and every (output column, part) one warp."""
    K, d_ff, n_out = 64, 256, 64
    gate, up, down, counts = _mlp_packs(K, d_ff, n_out, True, Mp)
    x = torch.randn(Mp, K, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    _, trace = pmlp.schedule_model(
        x, _trip(gate, "col_ptr"), _trip(up, "col_ptr"),
        _trip(down, "col_ptr"), counts, d_ff=d_ff, n_out=n_out, n_sm=1)
    for name, n in zip(("gate", "up", "down"), counts.tolist()):
        reads = trace["reads"][name]
        assert reads[:n] == [1] * n and not any(reads[n:])
    assert sorted(trace["owner"]) == list(range(d_ff // 16))
    split = pmlp.mlp_plan(d_ff, n_out, 1)["split"]
    parts = sorted(t for ts in trace["tasks"].values() for t in ts)
    assert parts == [(c, s) for c in range(n_out // 16) for s in range(split)]


@pytest.mark.parametrize("d_ff,n_out,split", [(11008, 2048, 16),
                                              (9216, 2304, 14)])
def test_mlp_split_plan_fills_the_card(d_ff, n_out, split):
    """Shapes only, on an H100 (qwen2.5-3b's and gemma2-2b's widths): the
    phase-2 parts give each warp at most one part and leave idle fewer warps
    than one output column has parts, every thread block (so every SM) has
    both hidden columns and parts to walk, and each part keeps
    MIN_SPLIT_ROWS hidden block-rows on average."""
    plan = pmlp.mlp_plan(d_ff, n_out, H100_SMS)
    grid, warps = plan["grid"], plan["warps"]
    assert (grid, warps, plan["split"]) == (H100_SMS, 2112, split)
    tasks = (n_out // 16) * split
    assert warps - n_out // 16 < tasks <= warps
    # grid-wide warp t is warp t // grid of thread block t % grid
    assert {t % grid for t in range(tasks)} == set(range(grid))
    pairs = warps // 2
    owners = {c % pairs for c in range(d_ff // 16)}
    assert {p % grid for p in owners} == set(range(grid))
    assert (d_ff // 16) / split >= pmlp.MIN_SPLIT_ROWS


# ------------------------------------------------------ the GEMV's schedule
def _gemv_pack(case, device="cpu"):
    """(x (8, K) with ``m`` real rows, pack, N) of a GEMV schedule case."""
    from repro_torch.core import sparsity as sp
    K, N, how = GEMV_CASES[case]
    seed = len(case)
    g = torch.Generator().manual_seed(seed)
    if how == "one block a column":
        w = torch.zeros(K, N)
        for c in range(N // 16):
            r = (5 * c) % (K // 16)
            w[16 * r:16 * (r + 1), 16 * c:16 * (c + 1)] = torch.randn(
                16, 16, generator=g)
        pack = psparse.pack_weight(w, 16, 16, torch.bfloat16)
    elif how == "emptied columns":
        # pack_weight gives each emptied column one explicit zero block
        w = sp.block_magnitude_prune(torch.randn(K, N, generator=g), 0.6, 16,
                                     16)
        w[:, :16] = 0
        w[:, 16 * 9:16 * 11] = 0
        pack = psparse.pack_weight(w, 16, 16, torch.bfloat16)
    else:
        pack = _port_pack(K, N, 0.75, seed, "cpu")
        if how == "padded":
            pack = psparse.pad_packed(pack, pack["blocks"].shape[0] + 21)
    x = torch.randn(8, K, generator=g).bfloat16()
    return x.to(device), {k: v.to(device) for k, v in pack.items()}, N


GEMV_CASES = {    # K, N, how the pack is made
    "one block a column": (256, 512, "one block a column"),
    "emptied columns": (256, 528, "emptied columns"),
    "padded pack": (512, 256, "padded"),
    "qwen2.5-3b up": (2048, 11008, "port"),
    "qwen2.5-3b down": (11008, 2048, "port"),
}


@pytest.mark.parametrize("case", sorted(GEMV_CASES))
@pytest.mark.parametrize("n_sm", [1, 132])
def test_gemv_schedule_model_matches_plain(case, n_sm):
    """The GEMV's schedule (each block-column's segment cut into gemv_plan's
    split parts of equal block counts, one a warp; the parts' partials added
    in split order; bias and silu at the flush) computes the plain GEMV:
    every payload block is read exactly once (a pad, zero, adds nothing),
    each column's parts are added in split order, and the result is the
    plain one within 1e-5 of max |out| (fp32 sums of the same bf16 products
    in another order). On a one-SM card the split is smaller than on an
    H100's."""
    x, p, N = _gemv_pack(case)
    bias = torch.randn(N, generator=torch.Generator().manual_seed(N))
    got, trace = pbm.gemv_schedule_model(
        x, p["blocks"], p["row_ids"], p["col_ptr"], n_out=N, bias=bias,
        activation="silu", n_sm=n_sm)
    want = pbm.bcsc_gemv_plain(x, p["blocks"], p["row_ids"], p["col_ids"],
                               n_out=N, bias=bias, activation="silu")
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    split = trace["split"]
    assert split == pbm.gemv_plan(x.shape[1], N, n_sm)["split"]
    assert trace["reads"] == [1] * p["blocks"].shape[0]
    assert trace["order"] == {c: list(range(split)) for c in range(N // 16)}
    # part s of column c: warp s of thread block c
    assert trace["warp"] == {(c, s): (c, s) for c in range(N // 16)
                             for s in range(split)}
    assert pbm.gemv_plan(x.shape[1], N, n_sm)["grid"] == N // 16


@pytest.mark.parametrize("K,N,split", [(2048, 11008, 3), (11008, 2048, 16),
                                       (2304, 9216, 3), (9216, 2304, 14)])
def test_gemv_plan_fills_the_card(K, N, split):
    """Shapes only, on an H100 (qwen2.5-3b's up and down projections, and
    gemma2-2b's widths): one part a warp and one thread block a column,
    GEMV_WARPS_PER_SM warps an SM with fewer idle than one column has
    parts, each part at least MIN_PART_ROWS block-rows of K on average; the
    down projection's ~128 columns are cut 16 ways, not left on 128
    warps."""
    plan = pbm.gemv_plan(K, N, H100_SMS)
    assert plan["split"] == split <= pbm.GEMV_MAX_SPLIT
    assert plan["warps"] == H100_SMS * pbm.GEMV_WARPS_PER_SM
    tasks = plan["tasks"]
    assert tasks == (N // 16) * split
    assert plan["warps"] - N // 16 < tasks <= plan["warps"]
    assert plan["grid"] == N // 16 and plan["threads"] == 32 * split
    assert (K // 16) / split >= pbm.MIN_PART_ROWS
    # a thread block's rings fit the shared memory a block may take
    assert plan["smem_bytes"] <= 232448


def test_gemv_constants_match_the_kernel():
    """The planner's copies of the GEMV's launch constants agree with
    csrc/bcsc_matmul.cu and the walk's ring slot in csrc/common.cuh; the
    old walk (scalar loads on the CUDA cores) is gone."""
    gemv = (CSRC / "bcsc_matmul.cu").read_text()
    assert f"kGemvRows = {pbm.GEMV_ROWS};" in gemv
    assert f"kGemvMaxWarps = {pbm.GEMV_MAX_SPLIT};" in gemv
    assert f"kGemvStages = {pbm.GEMV_STAGES};" in gemv
    assert "WarpWalk<1, kGemvStages>" in gemv
    common = (CSRC / "common.cuh").read_text()
    assert "kSlot = 512 + NT * 8 * 32;" in common
    assert pbm.GEMV_SLOT == 512 + 8 * 32
    for gone in ("segment_walk8", "load16", "kWalk"):
        assert gone not in common + gemv


def test_mlp_and_rs_constants_match_the_kernels():
    """The planners' copies of the kernels' constants (the launch of
    bcsc_mlp.cu, the arms and units of rs_matmul.cu) agree with the
    sources, and the fused MLP's resident blocks fit an SM's shared
    memory."""
    mlp = (CSRC / "bcsc_mlp.cu").read_text()
    assert f"kMlpWarps = {pmlp.MLP_WARPS};" in mlp
    assert f"kMlpBlocksPerSm = {pmlp.MLP_BLOCKS_PER_SM};" in mlp
    # the warp walk's ring, which the fused MLP shares with the GEMV
    stages = " : ".join(f"NT == {nt} ? {pmlp.ring_stages(nt)}"
                        for nt in (1, 2, 4)) + f" : {pmlp.ring_stages(8)};"
    assert stages in (CSRC / "common.cuh").read_text()
    for Mp in (8, 16, 24, 32, 64):
        lc = pmlp.launch_config(Mp, 11008, 2048, H100_SMS)
        assert lc["row_tiles"] * 8 >= Mp
        assert pmlp.MLP_BLOCKS_PER_SM * (lc["smem_bytes"] + 1024) <= 232448
    rs = (CSRC / "rs_matmul.cu").read_text()
    assert f"kSkMaxRows = {prs.STREAM_M_MAX};" in rs
    assert f"kSkN = {prs.STREAM_N};" in rs and f"kSkK = {prs.STREAM_K};" in rs
    assert f"kRsBM = {prs.TILE}, kRsBN = {prs.TILE}," in rs


@pytest.mark.parametrize("M,K,N,arm,units,grid", [
    (512, 2304, 9216, "wgmma", 288, 132),    # three rounds of 128 x 128
    (8, 2304, 9216, "stream", 1296, 132),    # 144 column tiles x 9 k parts
    (16, 300, 70, "stream", 4, 4),
    (17, 300, 70, "wgmma", 1, 1),
])
def test_rs_matmul_launch_config(M, K, N, arm, units, grid):
    """The arm and work units rs_matmul launches on an H100: the
    weight-streaming arm (64 columns x 256 k a unit, K parts added in
    order) up to 16 rows, 128 x 128 wgmma tiles above."""
    lc = prs.launch_config(M, K, N, H100_SMS)
    assert (lc["arm"], lc["units"], lc["grid"]) == (arm, units, grid)
    assert lc["smem_bytes"] <= 232448


@pytest.mark.parametrize("M,K,N,plan", [
    (512, 2304, 9216, (288, 132, 24, 5)),   # 2 full rounds + 24 tiles in K
    (1100, 300, 2000, (144, 132, 12, 5)),   # parts capped by K's 5 k-tiles
    (128, 2304, 9216, (72, 72, 0, 1)),      # one round: nothing split
    (4096, 4096, 4096, (1024, 132, 0, 1)),  # a nearly full last round
])
def test_rs_matmul_wgmma_plan(M, K, N, plan):
    """Shapes only, on an H100: the tensor-core arm splits the last, partial
    round of tiles in K (one part a block, at most one part a k-tile) when
    that leaves every block at least two parts' worth of the round, so the
    busiest block does about the average work."""
    got = prs.wgmma_plan(M, K, N, H100_SMS)
    assert (got["tiles"], got["grid"], got["split"], got["parts"]) == plan
    if got["split"]:
        assert got["split"] * got["parts"] <= got["grid"]


def test_rs_matmul_reads_tma_ready_operands_in_place():
    """A contiguous bf16 operand whose rows are a multiple of 16 bytes is
    passed as it is (the same tensor: no copy); one whose rows are not gets
    a copy padded to 8 columns, the padding zero."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(300, 72, generator=g).bfloat16()
    assert prs._tma_ready(w) is w
    odd = torch.randn(300, 70, generator=g).bfloat16()
    padded = prs._tma_ready(odd)
    assert padded.shape == (300, 72) and padded.is_contiguous()
    assert torch.equal(padded[:, :70], odd)
    assert not padded[:, 70:].any()
    view = w[:, :64]
    assert prs._tma_ready(view).is_contiguous()


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
    # a meta tensor takes the plain version (shapes only, a cell's step on
    # meta); a device that is neither the CPU, meta nor CUDA is refused
    assert pops._use_kernel(x.to("meta"), None) is False

    class OnDevice:
        device = torch.device("xpu")
    with pytest.raises(RuntimeError, match="no kernel"):
        pops._use_kernel(OnDevice(), None)


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


def _flash_fp32(ref, q, k, v, window, softcap, chunk=0):
    """``models.flash``'s forward in fp32 (before its bf16 cast), in the
    mode and block size that ``models.layers._flash_call`` picks (chunk
    mode when ``chunk`` is given)."""
    jnp = ref.jnp
    B, S, H, D = q.shape
    KV = k.shape[2]
    blk = pswa.block_size(S)
    mode = "chunk" if chunk else "causal" if window >= S else "window"
    qf = jnp.asarray(q, jnp.bfloat16).reshape(B, S, KV, H // KV, D) \
        .transpose(0, 2, 3, 1, 4)
    kf = jnp.asarray(k, jnp.bfloat16).transpose(0, 2, 1, 3)
    vf = jnp.asarray(v, jnp.bfloat16).transpose(0, 2, 1, 3)
    msize = {"chunk": chunk, "window": window}.get(mode, S)
    out, _ = ref.flash._fwd_impl(qf, kf, vf, jnp.arange(S, dtype=jnp.int32),
                                 mode, msize, softcap, blk, blk)
    return np.asarray(out).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D)


def _port_swa(q, k, v, window, softcap, **kw):
    return pops.sliding_window_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), window=window, softcap=softcap,
        **kw)


@pytest.mark.parametrize("S,window,R", [(40, 40, 2), (40, 12, 2),
                                        (100, 100, 2), (100, 33, 2),
                                        (300, 300, 2), (300, 70, 2),
                                        (1100, 600, 2), (100, 33, 5),
                                        (300, 300, 5), (130, 40, 10),
                                        (300, 70, 10)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_sliding_window_plain_matches_flash(ref, monkeypatch, S, window, R,
                                            softcap):
    """The plain version is ``models/flash.py``'s forward: the same block
    schedule (ragged S, several blocks, causal and window modes, blocks
    skipped), the same fp32 online softmax and bf16 PV, at head ratios R 2
    and, as llama4 (40/8) and recurrentgemma-2b (10/1) have them, 5 and 10.
    With XLA's exp and tanh in place of torch's, every output is within
    1e-5. With torch's own, which differ from XLA's in the last fp32 bits, a
    p now and then rounds to the other bf16 neighbour (2^-8 of it): 99 % of
    the outputs stay within 1e-5, and each (position, head) row within 2e-3
    of its own max |out|."""
    q, k, v = _swa_case(S, R=R, D=16 if S < 1000 else 8,
                        seed=S + window + 10 * (R - 2))
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


@pytest.mark.parametrize("S,window", [(40, 40), (100, 100), (100, 33)])
def test_sliding_window_plain_matches_pallas_at_head_dim_64(ref, S, window):
    """Head dim 64 with one query head per KV head (musicgen-large: 32 /
    32 heads of 64), causal and in window mode, against the Pallas band
    kernel in interpret mode and the exact oracle (both keep p in fp32):
    2e-2 of max |out|, as at head dim 16."""
    jnp = ref.jnp
    q, k, v = _swa_case(S, KV=2, R=1, D=64, seed=S + window)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = _port_swa(q, k, v, window, 0.0).numpy()
    for want in (ref.ops.sliding_window_attention(*args, window=window),
                 ref.oracles.sliding_window_attention_ref(*args, window)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("R", [1, 2, 5, 6, 8, 10])
@pytest.mark.parametrize("S", [1, 70, 300])
def test_sliding_window_row_map_covers_each_row_once(R, S):
    """A replay of the kernel's row map over ``launch_config``'s grid: q
    tile w of block (q tile pair, KV head g, batch row b) holds positions
    q0 + w * per_tile + r // R and heads g * R + r % R in its first ``live``
    rows r; each (batch row, position, head) is read and written by exactly
    one row, the ``dead_rows`` (4 of 64 at R 5, 6 and 10) by none. The
    kernel source computes that map and refuses only R past 64."""
    B, KV, D = 2, 2, 128
    H = KV * R
    lc = pswa.launch_config(B, S, H, KV, D)
    per_tile, live = lc["per_tile"], lc["live"]
    assert live + lc["dead_rows"] == pswa.TILE_ROWS
    assert lc["dead_rows"] == (4 if R in (5, 6, 10) else 0)
    per_block = pswa.WARPGROUPS * per_tile
    n_qt = -(-S // per_block)
    assert lc["blocks"] == n_qt * B * KV
    seen = {}
    for block in range(lc["blocks"]):
        qt = n_qt - 1 - block // (B * KV)          # longest first
        g, b = (block % (B * KV)) % KV, (block % (B * KV)) // KV
        for w in range(pswa.WARPGROUPS):
            for r in range(pswa.TILE_ROWS):
                pos = qt * per_block + w * per_tile + r // R
                if r >= live or pos >= S:
                    continue                       # dead, or past S
                key = (b, pos, g * R + r % R)
                seen[key] = seen.get(key, 0) + 1
    assert seen == {(b, p, h): 1 for b in range(B) for p in range(S)
                    for h in range(H)}
    src = (CSRC / "local_attention.cu").read_text()
    assert "const int pos = q0 + w * per_wg + r / R;" in src
    assert "const bool ok = r < live && pos < q_end && ch * 8 < D;" in src
    assert "H / KV > kSwaRows" in src and "kSwaRows % (H / KV)" not in src
    q = torch.zeros(1, 4, 65, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 64"):
        pswa.sliding_window_attention_cuda(q, kv, kv, window=4)


@pytest.mark.parametrize("S,chunk,R", [(100, 32, 2), (300, 96, 5),
                                       (130, 64, 10)])
def test_sliding_window_plain_chunk_mode(ref, S, chunk, R):
    """The chunk mode (a query at p sees the keys t <= p with t // c ==
    p // c) at S not a multiple of the block, chunks that do and do not
    divide the block: against a naive masked softmax in fp32 (q, k, v the
    same bf16 values, p kept fp32 where the port rounds it to bf16 for the
    PV product: 1e-2 of max |out|), and against flash's chunk mode, whose
    block schedule the plain version repeats (within 1e-5 but for the bf16
    p roundings that torch's exp and XLA's may part on, as in
    ``test_sliding_window_plain_matches_flash``)."""
    q, k, v = _swa_case(S, R=R, seed=S + chunk + R)
    got = _port_swa(q, k, v, S, 0.0, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    qf, kf, vf = (torch.from_numpy(a).bfloat16().float() for a in (q, k, v))
    kr, vr = kf.repeat_interleave(R, 2), vf.repeat_interleave(R, 2)
    pos = torch.arange(S)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] // chunk == pos[:, None] // chunk)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) / np.sqrt(q.shape[-1])
    naive = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
        s.masked_fill(~mask, -np.inf), dim=-1), vr)
    torch.testing.assert_close(got, naive, rtol=0,
                               atol=1e-2 * float(naive.abs().max()))
    want = _flash_fp32(ref, q, k, v, S, 0.0, chunk=chunk)
    diff = np.abs(got.numpy() - want)
    assert (diff <= 1e-5).mean() >= 0.99
    assert (diff.max(-1) <= 2e-3 * np.abs(want).max(-1)).all()
    with pytest.raises(ValueError, match="window >= S"):
        _port_swa(q, k, v, S - 1, 0.0, chunk=chunk)


def test_flash_attention_entry_is_causal_window(ref):
    """Full causal prefill attention (``layers.full_causal_attention``) is
    the sliding window with window = S."""
    q, k, v = _swa_case(24, seed=3)
    got = players.full_causal_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        types.SimpleNamespace(attn_logit_softcap=30.0))
    assert torch.equal(got, _port_swa(q, k, v, 24, 30.0).bfloat16())


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
                                            (4, 2, 256, 50.0),
                                            (8, 4, 128, 0.0),
                                            (8, 2, 256, 0.0)])
def test_cuda_paged_attention_matches_plain(cuda, KV, R, D, softcap):
    """qwen2.5-3b's head layout, gemma2-2b's (head_dim 256, softcap 50) on
    rows up to 6000 tokens, mistral-nemo-12b's (R 4, D 128) and gemma3-12b's
    (R 2, D 256, no softcap) on rows up to 3500 and 7024 tokens; fp and
    int8 pages."""
    lengths = {(2, 128): [64, 65, 1, 130], (4, 256): [6000, 7, 4724, 1523],
               (8, 128): [3532, 5, 1032, 96],
               (8, 256): [7024, 31, 4124, 1524]}[(KV, D)]
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
    pages, _ = ppa.split_plan(B, KV, MP, _build.sm_count(cuda.index or 0))
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
@pytest.mark.parametrize("KV,R,D,tp,int8,softcap", [
    (4, 2, 256, 2, False, 50.0),     # gemma2-2b at tp=2
    (2, 8, 128, 2, True, 0.0),       # qwen2.5-3b, int8 pages, at tp=2
    (8, 4, 128, 2, False, 0.0),      # mixtral-8x7b at tp=2
    (8, 4, 128, 4, True, 30.0)])
def test_cuda_paged_attention_shards_equal_one_launch(cuda, KV, R, D, tp,
                                                      int8, softcap):
    """tp launches over the unsliced pools (``kv_offset``, split as for the
    pool's head count), one per KV-head shard, concatenated, equal one
    launch over every head bit for bit (each (row, head) reduces its pages
    in the same splits), also at the speculative verifier's split
    (``split_rows``), and the plain version within 1e-4."""
    from repro_torch.sharding import tensor_parallel as tpar
    ps, B, MP = 64, 5, 96
    lengths = [0, 1, 700, 3000, 6000]
    q, kp, vp, bt, lens, sc = _paged_case(lengths, ps, KV=KV, R=R, D=D,
                                          int8=int8)
    table = np.full((B, MP), -1, np.int32)
    table[:, :bt.shape[1]] = bt
    dt = torch.int8 if int8 else torch.bfloat16
    args = (torch.from_numpy(q).bfloat16().to(cuda),
            torch.from_numpy(kp).to(dt).to(cuda),
            torch.from_numpy(vp).to(dt).to(cuda),
            torch.from_numpy(table).to(cuda), torch.from_numpy(lens).to(cuda))
    kw = {} if sc is None else dict(
        k_scale=torch.from_numpy(sc[0]).to(cuda),
        v_scale=torch.from_numpy(sc[1]).to(cuda))
    full = pops.paged_attention(*args, softcap=softcap, **kw)
    before = ppa.paged_attention_cuda.launches
    got = tpar.sharded_paged_attention(*args, tp, softcap=softcap, **kw)
    assert ppa.paged_attention_cuda.launches - before == tp
    plain = tpar.sharded_paged_attention(*args, tp, softcap=softcap,
                                         impl="plain", **kw)
    # the verify step: the rows as one real row's virtual rows
    full1 = pops.paged_attention(*args, softcap=softcap, split_rows=1, **kw)
    got1 = tpar.sharded_paged_attention(*args, tp, softcap=softcap,
                                        split_rows=1, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, full)
    assert torch.equal(got1, full1)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)
    torch.testing.assert_close(got1, plain, rtol=0, atol=1e-4)


@pytest.fixture
def cards():
    """Every CUDA device, when there are two or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: ServeMesh.device_mesh places "
                    "one shard per card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.gpu
def test_cuda_device_mesh_places_shards_on_cards(cards):
    """With a card per shard ``ServeMesh.device_mesh`` names them in (ep,
    tp) order; each shard's KV heads of a pool, placed on its card, give
    that shard's contexts there (plain version, against the first card's
    whole call within 1e-5)."""
    from repro_torch.serve.shard import ServeMesh
    from repro_torch.sharding import tensor_parallel as tpar
    mesh = ServeMesh(tp=2)
    assert mesh.backed and mesh.device_mesh() == [cards[:2]]
    q, kp, vp, bt, lens, _ = _paged_case([5, 30, 17], 8, KV=4, R=2, D=64)
    host = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
            torch.from_numpy(lens))
    want = pops.paged_attention(*(t.to(cards[0]) for t in host),
                                impl="plain")
    parts = []
    for s, dev in enumerate(mesh.device_mesh()[0]):
        heads = slice(2 * s, 2 * s + 2)
        local = (tpar.shard_slice(host[0], 2, s, 2), host[1][:, :, heads],
                 host[2][:, :, heads], host[3], host[4])
        out = pops.paged_attention(*(t.contiguous().to(dev) for t in local),
                                   impl="plain")
        assert out.device == dev
        parts.append(out.to(cards[0]))
    torch.testing.assert_close(torch.cat(parts, dim=2), want, rtol=0,
                               atol=1e-5)


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
@pytest.mark.parametrize("case", sorted(GEMM_WALK_CASES))
def test_cuda_bcsc_gemm_edges(cuda, case):
    """The GEMM kernel against the plain product at the walk's edges (M 16
    and 48 in 64- and 128-row tiles, N / 16 odd, pads, empty columns, K past
    one indexed chunk), on the planner's plan and on others, including a
    K split: 1e-3 of max |out| (tensor-core fp32 sums of the same bf16
    products in another order). Two runs agree bit for bit."""
    x, p, N = _walk_case(case, cuda)
    want = pbm.bcsc_matmul_plain(x, p["blocks"], p["row_ids"], p["col_ids"],
                                 n_out=N)
    args = (x, p["blocks"], p["row_ids"], p["col_ptr"])
    got = [pbm.bcsc_matmul_cuda(*args, n_out=N)]
    got += [pbm.gemm_launch(*args, N, bm, split)
            for bm, split in ((64, 1), (128, 1), (128, 3))]
    again = pbm.bcsc_matmul_cuda(*args, n_out=N)
    torch.cuda.synchronize()
    for g in got:
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-3 * float(want.abs().max()))
    assert torch.equal(got[0], again)


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
@pytest.mark.parametrize("S,window,R,D", [
    (300, 300, 2, 256), (300, 70, 2, 256), (200, 200, 8, 128),
    (130, 40, 1, 64), (300, 300, 5, 128), (300, 70, 5, 128),
    (300, 300, 6, 128), (300, 70, 6, 128), (300, 300, 10, 256),
    (300, 70, 10, 256)])
def test_cuda_sliding_window_matches_plain(cuda, S, window, R, D):
    """The kernel walks keys in another order than flash's schedule and
    sums its tensor-core products in its own: 1e-3 of max |out|. R 5, 6
    and 10 (llama4, internvl2-26b, recurrentgemma-2b) leave dead rows in
    every tile."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, KV=2, R=R, D=D, seed=S))
    got = pops.sliding_window_attention(q, k, v, window=window, softcap=50.0)
    want = pops.sliding_window_attention(q, k, v, window=window,
                                         softcap=50.0, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(2500, 1024), (1024, 1024),
                                      (1025, 1024)])
def test_cuda_sliding_window_gemma3_local(cuda, S, window):
    """gemma3-12b's local layers: window 1024, 16 query heads over 8 KV
    heads of 256, no softcap; a prompt past the window (window mode), one
    that fills it (causal) and one a key past it: 1e-3 of max |out|."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, B=1, KV=8, R=2, D=256, seed=S))
    got = pops.sliding_window_attention(q, k, v, window=window, softcap=0.0)
    want = pops.sliding_window_attention(q, k, v, window=window, softcap=0.0,
                                         impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(300, 70), (300, 300), (130, 40),
                                      (4097, 4096)])
@pytest.mark.parametrize("R", [1, 2, 5, 6, 8, 10])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_cuda_sliding_window_tile_edges(cuda, S, window, R, D, softcap):
    """S and window not multiples of the 64-key tile (ragged last q and key
    tiles, the band's far edge inside a tile, masked and unmasked tiles),
    4097 with a 4096 window (one key past the window, the global causal
    shape's long walk), at head ratios that divide the 64-row tile and at
    5, 6 and 10, which leave 4 dead rows in it: 1e-3 of max |out|."""
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
@pytest.mark.parametrize("S,chunk,R,D", [(300, 96, 5, 128), (300, 64, 5, 128),
                                         (300, 100, 2, 64),
                                         (130, 40, 10, 256),
                                         (1000, 250, 8, 128),
                                         (4097, 2048, 4, 128)])
def test_cuda_sliding_window_chunk_tile_edges(cuda, S, chunk, R, D):
    """The chunk mode where chunk starts fall inside key tiles (96, 100,
    40, 250: a tile that straddles a start is masked element by element)
    and on tile bounds (64, 2048), at head ratios with and without dead
    rows: 1e-3 of max |out| against the plain version."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, B=1 if S > 1000 else 2, KV=2, R=R, D=D,
                                  seed=S + chunk + R))
    got = pops.sliding_window_attention(q, k, v, window=S, chunk=chunk)
    want = pops.sliding_window_attention(q, k, v, window=S, chunk=chunk,
                                         impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,window,chunk,R,D,softcap", [
    (300, 300, 0, 4, 128, 0.0), (200, 96, 0, 2, 256, 50.0),
    (260, 260, 100, 5, 64, 0.0)])
def test_cuda_sliding_window_lse_matches_plain(cuda, S, window, chunk, R, D,
                                               softcap):
    """The forward's log-sum-exp (written only when asked for) against the
    plain version's: 1e-5 of max |lse| (the kernel's ex2 and log against
    torch's exp and log); the output is the same bits with and without
    it."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, KV=2, R=R, D=D, seed=S + R))
    kw = dict(window=window, chunk=chunk, softcap=softcap)
    out, lse = pops.sliding_window_attention(q, k, v, return_lse=True, **kw)
    _, want = pops.sliding_window_attention(q, k, v, return_lse=True,
                                            impl="plain", **kw)
    bare = pops.sliding_window_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (2, S, 2 * R)
    torch.testing.assert_close(lse, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(out, bare)


def _chip_smoke_shapes():
    """``BACKWARD_SHAPES`` and ``SEQSHARD_SHAPES`` of chip_smoke.py (whose
    module level imports only the standard library)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_shapes", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.BACKWARD_SHAPES, mod.SEQSHARD_SHAPES


def test_flash_backward_launch_config_fits_the_card():
    """The backward's launches at chip_smoke's shapes (each shard of the
    sequence-sharded ones) and at D 64, 128 and 256: each kernel's shared
    memory within the H100's 227 KB a block, the groups a divisor of R
    below R (when R > 1), the dk/dv grid at qwen2.5-3b's training shape
    (B 1, S 2048, 2 KV heads) at least one block per SM, the blocks'
    threads the kernel's, and no mma.sync, atomics or per-head shares left
    in it."""
    backward, seqshard = _chip_smoke_shapes()
    cases = [dict(B=B, S=S, H=H, KV=KV, D=D, window=w, chunk=c)
             for B, S, H, KV, D, w, c, _ in backward.values()]
    for B, S, H, KV, D, w, _, n in seqshard.values():
        cases += [dict(B=B, S=S, H=H, KV=KV, D=D, window=w, q_offset=i * S
                       // n, Sq=S // n) for i in range(n)]
    cases += [dict(B=1, S=4096, H=H, KV=KV, D=D)
              for D in (64, 128, 256) for H, KV in ((16, 2), (8, 8), (40, 8))]
    for case in cases:
        lc = pfb.launch_config(**case)
        R = case["H"] // case["KV"]
        assert lc["dq_smem_bytes"] <= pfb.SMEM_LIMIT, case
        assert lc["dkv_smem_bytes"] <= pfb.SMEM_LIMIT, case
        assert R % lc["groups"] == 0 and (lc["groups"] < R or R == 1), case
        assert lc["dq_tile"] == lc["dq_wgs"] * (64 // R), case
    qwen = pfb.launch_config(1, 2048, 16, 2, 128)
    assert qwen["dkv_blocks"] >= pfb.SM_COUNT and qwen["groups"] > 1
    assert pfb.launch_config(1, 8192, 8, 4, 256)["groups"] == 1
    src = (CSRC / "flash_backward.cu").read_text()
    assert "kThreads = 128 * kWgs + 32;" in src
    assert "kThreads = 128 * kWgs;" in src
    assert qwen["dq_threads"] == 288 and qwen["dkv_threads"] == 256
    for gone in ("mma_16816", "atomicAdd", "dk_part"):
        assert gone not in src


@pytest.mark.gpu
@pytest.mark.parametrize("S,window,chunk,KV,R,D,softcap", [
    (300, 300, 0, 2, 8, 128, 0.0), (200, 96, 0, 2, 2, 256, 50.0),
    (260, 260, 100, 2, 5, 64, 0.0), (300, 100, 0, 2, 5, 128, 0.0),
    (190, 190, 0, 1, 4, 64, 0.0), (330, 150, 0, 2, 3, 256, 30.0),
    (400, 400, 96, 2, 8, 128, 0.0), (150, 150, 0, 2, 2, 192, 0.0),
    (140, 140, 0, 2, 4, 80, 0.0)])
def test_cuda_flash_backward_matches_plain(cuda, S, window, chunk, KV, R, D,
                                           softcap):
    """The backward kernel against its plain version on the same inputs
    (the kernel forward's bf16 output and log-sum-exp): dq, dk and dv
    within 2e-3 of each one's max |value| (the kernel's ex2 and tanhf can
    move a bf16 rounding of p or ds by one step, and its fp32 sums run in
    another order); a second call gives the same bits (no atomics). The
    cases after the first three reach the kernels' edges: 5 heads a KV
    head (4 dead rows of each dq tile) with a window across key tiles; S
    not a multiple of 64 with one KV head, where ``launch_config`` cuts
    the 4 heads into groups; D 256 with a softcap and a window at 3 heads
    (the dk/dv warpgroups split the columns); a chunk of 96 that starts
    inside key tiles; D 192 (the split with 2 + 1 column blocks) and D 80
    (a column block half past D)."""
    rng = np.random.default_rng(S + R + D)
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, B=2, KV=KV, R=R, D=D, seed=S + R))
    dout = torch.from_numpy(_bf16(rng, (2, S, KV * R, D))).bfloat16().to(
        cuda)
    kw = dict(window=window, chunk=chunk, softcap=softcap)
    out, lse = pops.sliding_window_attention(q, k, v, return_lse=True, **kw)
    out16 = out.bfloat16()
    got = pops.flash_backward(q, k, v, out16, lse, dout, **kw)
    again = pops.flash_backward(q, k, v, out16, lse, dout, **kw)
    want = pops.flash_backward(q, k, v, out16, lse, dout, impl="plain", **kw)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=2e-3 * float(w.abs().max()),
                                   msg=name)
        assert torch.equal(g, a), name


@pytest.mark.gpu
@pytest.mark.parametrize("S,window,chunk,KV,R,D,softcap,shards", [
    (1024, 1024, 0, 2, 8, 128, 0.0, 4), (1024, 300, 0, 4, 2, 256, 50.0, 2),
    (768, 768, 256, 2, 5, 64, 0.0, 3), (864, 864, 256, 2, 5, 64, 0.0, 3),
    (600, 600, 0, 2, 8, 128, 0.0, 3)])
def test_cuda_query_offset_matches_plain_and_one_launch(
        cuda, S, window, chunk, KV, R, D, softcap, shards):
    """Both kernels on ``shards`` slices of the query rows at their offsets
    (``q_offset``), each against the whole K and V: against their plain
    versions at the same offset (out 1e-3, lse 1e-5, dq, dk, dv 2e-3, each
    of the whole launch's max |value|: the whole launch's tolerances; a
    later slice's rows average more keys and are smaller, so their own max
    would tighten them), and against one launch over every row
    (the slices' dq from the whole launch's out16 and lse): out and lse
    bit for bit where an offset is a multiple of a block's 2 x (64 // R)
    positions, dq where it is a multiple of the dq kernel's block
    (``launch_config``'s ``dq_tile``), the slices' dk and dv shares summed
    within 1e-5 of max. The first two shapes are qwen's
    ratio and gemma2's local layers; 5 heads a KV head leave a shard
    start of 256 inside a block, while shards of 288 rows are whole dq
    and forward blocks (36 and 24 positions at D 64), so both bit checks
    run at 5 heads; 200 rows fall inside both kernels' tiles."""
    rng = np.random.default_rng(S + R + shards)
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, B=2, KV=KV, R=R, D=D, seed=S + R))
    dout = torch.from_numpy(_bf16(rng, (2, S, KV * R, D))).bfloat16().to(
        cuda)
    kw = dict(window=window, chunk=chunk, softcap=softcap)
    out, lse = pops.sliding_window_attention(q, k, v, return_lse=True, **kw)
    out16 = out.bfloat16()
    whole = pops.flash_backward(q, k, v, out16, lse, dout, **kw)
    n = S // shards
    per_block = 2 * (64 // R)
    dq_tile = pfb.launch_config(2, S, KV * R, KV, D)["dq_tile"]
    dkv = [torch.zeros_like(whole[1]), torch.zeros_like(whole[2])]
    for i in range(shards):
        rows, off = slice(i * n, (i + 1) * n), i * n
        o_i, l_i = pops.sliding_window_attention(
            q[:, rows], k, v, return_lse=True, q_offset=off, **kw)
        po, pl = pops.sliding_window_attention(
            q[:, rows], k, v, return_lse=True, q_offset=off, impl="plain",
            **kw)
        args = (q[:, rows], k, v, out16[:, rows], lse[:, rows],
                dout[:, rows])
        got = pops.flash_backward(*args, q_offset=off, **kw)
        want = pops.flash_backward(*args, q_offset=off, impl="plain", **kw)
        torch.cuda.synchronize()
        assert o_i.shape == (2, n, KV * R, D) and l_i.shape == (2, n, KV * R)
        torch.testing.assert_close(o_i, po, rtol=0,
                                   atol=1e-3 * float(out.abs().max()))
        torch.testing.assert_close(l_i, pl, rtol=0,
                                   atol=1e-5 * float(lse.abs().max()))
        for name, g, w, top in zip(("dq", "dk", "dv"), got, want, whole):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=2e-3 * float(top.abs().max()),
                                       msg=name)
        if off % per_block == 0 and n % per_block == 0:
            assert torch.equal(o_i, out[:, rows])
            assert torch.equal(l_i, lse[:, rows])
        if off % dq_tile == 0 and n % dq_tile == 0:
            assert torch.equal(got[0], whole[0][:, rows])
        dkv[0] += got[1]
        dkv[1] += got[2]
    for name, g, w in zip(("dk", "dv"), dkv, whole[1:]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()), msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(2048, 2048, 256), (300, 96, 1000)])
def test_cuda_matmul_backward_matches_fp64(cuda, M, K, N):
    """``layers.matmul``'s backward as the card runs it (the fp32
    cotangent rounded to bf16, bf16 products with fp32 sums, each operand's
    cotangent rounded once to bf16) against fp64 products of the forward's
    bf16 operands and the unrounded cotangent: dx and dw within 8e-3 of
    each one's max |value| and 3e-3 in Frobenius norm (two bf16 roundings,
    the cotangent's and the result's, each within 2^-9 relative, about
    1.1e-3 rms). The first shape is qwen2.5-3b's k projection over 2048
    positions."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=gen).bfloat16()
    w = torch.randn(K, N, device=cuda, generator=gen) / K ** 0.5
    g = torch.randn(M, N, device=cuda, generator=gen)
    x.requires_grad_()
    w.requires_grad_()
    y = players.matmul(x, w)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(dw, dw.bfloat16().float())
    xd, wd, gd = (t.detach().double() for t in (x, w.bfloat16(), g))
    for name, got, want in (("dx", dx, gd @ wd.t()), ("dw", dw, xd.t() @ gd)):
        diff = got.double() - want
        err = float(diff.abs().max() / want.abs().max())
        fro = float(torch.linalg.norm(diff) / torch.linalg.norm(want))
        assert err <= 8e-3 and fro <= 3e-3, (name, err, fro)


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


@pytest.mark.gpu
@pytest.mark.parametrize("Mp", [8, 16, 24, 64])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_cuda_bcsc_mlp_edges(cuda, Mp, gated, act):
    """The fused MLP kernel at every row-tile count it instantiates, gated
    and ungated, each activation, over packs with pads past their counts
    and an empty hidden and output block-column: 2e-3 of max |out| (an
    fp32 sum in another order can flip one bf16 rounding of the hidden).
    Two calls give equal bits (fixed sum order, no atomics on floats)."""
    K, d_ff, n_out = 256, 1024, 256
    gate, up, down, counts = _mlp_packs(K, d_ff, n_out, gated, Mp, cuda)
    x = torch.randn(Mp, K, device=cuda).bfloat16()
    kw = dict(d_ff=d_ff, n_out=n_out, activation=act)
    got = pmlp.bcsc_mlp_cuda(x, _trip(gate, "col_ptr"), _trip(up, "col_ptr"),
                             _trip(down, "col_ptr"), counts, **kw)
    again = pmlp.bcsc_mlp_cuda(x, _trip(gate, "col_ptr"),
                               _trip(up, "col_ptr"), _trip(down, "col_ptr"),
                               counts, **kw)
    want = pmlp.bcsc_mlp_plain(x, _trip(gate, "col_ids"),
                               _trip(up, "col_ids"), _trip(down, "col_ids"),
                               counts, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))
    assert torch.equal(got, again)
    assert not got[:, :16].any()          # the empty output block-column


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 16, 100, 512])
@pytest.mark.parametrize("act,bias,out_dtype", [
    (None, False, "float32"), ("relu", True, "float32"),
    ("silu", True, "bfloat16"), ("gelu", True, "float32")])
def test_cuda_rs_matmul_edges(cuda, M, act, bias, out_dtype):
    """Both arms (weight streaming up to 16 rows, wgmma tiles above) at
    ragged K 300 and N 70 (TMA reads past the edges as zeros, stores are
    predicated), with and without bias, each activation, fp32 and bf16
    out: 1e-4 of max |out| in fp32 (sums of the same bf16 products in
    another order), and in bf16 one rounding of the output (2^-8 of it)
    on top. Two calls give equal bits."""
    K, N = 300, 70
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(K, N, generator=g, device=cuda) / K ** 0.5).bfloat16()
    b = torch.randn(N, generator=g, device=cuda) if bias else None
    dt = getattr(torch, out_dtype)
    got = prs.rs_matmul_cuda(x, w, bias=b, activation=act, out_dtype=dt)
    again = prs.rs_matmul_cuda(x, w, bias=b, activation=act, out_dtype=dt)
    want = prs.rs_matmul_plain(x, w, bias=b, activation=act)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want.to(dt).float(),
                               rtol=2 ** -8 if dt == torch.bfloat16 else 0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(512, 2304, 9216), (1100, 300, 2000)])
def test_cuda_rs_matmul_split_last_round(cuda, M, K, N):
    """Shapes whose last round of tiles is split in K (wgmma_plan): the
    parts' raw partials added in part order by the second kernel, then the
    epilogue: 1e-4 of max |out|, equal bits on a second call."""
    assert prs.wgmma_plan(M, K, N, _build.sm_count(cuda.index or 0))[
        "parts"] > 1
    g = torch.Generator(device=cuda).manual_seed(K)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(K, N, generator=g, device=cuda) / K ** 0.5).bfloat16()
    b = torch.randn(N, generator=g, device=cuda)
    got = prs.rs_matmul_cuda(x, w, bias=b, activation="gelu")
    again = prs.rs_matmul_cuda(x, w, bias=b, activation="gelu")
    want = prs.rs_matmul_plain(x, w, bias=b, activation="gelu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 512])
def test_cuda_rs_matmul_copies_nothing(cuda, M):
    """On contiguous bf16 operands the wrapper passes x and w as they are:
    the call allocates its output and the partials of parts split in K,
    but nothing of w's size."""
    K, N = 2304, 9216
    x = torch.randn(M, K, device=cuda).bfloat16()
    w = (torch.randn(K, N, device=cuda) / K ** 0.5).bfloat16()
    b = torch.randn(N, device=cuda)
    prs.rs_matmul_cuda(x, w, bias=b, activation="gelu")   # built, warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = prs.rs_matmul_cuda(x, w, bias=b, activation="gelu")
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda) - before
    assert grew < w.numel() * w.element_size()
    assert grew >= out.numel() * out.element_size()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GEMV_CASES) + [
    "more blocks a part than the ring holds"])
@pytest.mark.parametrize("M", [1, 8])
def test_cuda_bcsc_gemv_edges(cuda, case, M):
    """The GEMV kernel against its plain version on packs with one block a
    column, emptied columns (one explicit zero block each), pads, both of
    qwen2.5-3b's shapes and one whose parts hold more blocks than the
    16-slot ring and than a batch of 32 row ids (split 1, 64 blocks a
    column), with 1 and 8 real rows, each activation with and without
    bias: 1e-4 of max |out| (fp32 sums of the same bf16 products in another
    order). Two calls give equal bits, and so does a call on a second
    stream."""
    if case in GEMV_CASES:
        x, p, N = _gemv_pack(case, cuda)
    else:
        K, N = 1024, 16 * 2176     # more columns than warps: split 1
        assert pbm.gemv_plan(K, N, _build.sm_count(cuda.index or 0))[
            "split"] == 1
        x = torch.randn(8, K, device=cuda).bfloat16()
        p = psparse.pack_weight(torch.randn(K, N, device=cuda) / K ** 0.5,
                                16, 16, torch.bfloat16)
    x[M:] = 0
    args = (x, p["blocks"], p["row_ids"], p["col_ptr"])
    bias = torch.randn(N, device=cuda)
    side = torch.cuda.Stream(cuda)
    for act in (None, "relu", "silu", "gelu"):
        for b in (None, bias):
            kw = dict(n_out=N, bias=b, activation=act)
            got = pbm.bcsc_gemv_cuda(*args, **kw)
            again = pbm.bcsc_gemv_cuda(*args, **kw)
            side.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(side):
                other = pbm.bcsc_gemv_cuda(*args, **kw)
            torch.cuda.current_stream(cuda).wait_stream(side)
            want = pbm.bcsc_gemv_plain(x, p["blocks"], p["row_ids"],
                                       p["col_ids"], **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got[:M], want[:M], rtol=0,
                atol=1e-4 * float(want[:M].abs().max()))
            assert torch.equal(got, again) and torch.equal(got, other)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,M", [("musicgen-large", 4),
                                    ("musicgen-large", 64),
                                    ("internvl2-26b", 4)])
def test_cuda_bcsc_mlp_at_frontend_widths(cuda, arch, M):
    """The fused MLP at the widths of the frontend models' MLPs, packed at
    0.75: musicgen-large's ungated tanh-gelu 2048 -> 8192 -> 2048 at its
    decode rows (4) and a prefill on the fused route, internvl2-26b's
    gated silu 6144 -> 16384 -> 6144 at 4 rows; 2e-3 of max |out|."""
    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    names = ((d, ff, 1), (d, ff, 2), (ff, d, 3)) if cfg.mlp_gated \
        else ((d, ff, 1), (ff, d, 3))
    packs = [_port_pack(K, N, 0.75, s, cuda) for K, N, s in names]
    if not cfg.mlp_gated:
        packs.insert(1, None)
    x = torch.randn(M, d, device=cuda).bfloat16()
    act = "silu" if cfg.mlp_act == "silu" else "gelu"
    kw = dict(d_ff=ff, n_out=d, plan=_plan(), activation=act)
    got = pops.bcsc_mlp_packed(x, *packs, **kw)
    want = pops.bcsc_mlp_packed(x, *packs, impl="plain", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,KV,D", [(1024, 32, 32, 64),
                                      (300, 48, 8, 128)])
def test_cuda_sliding_window_at_frontend_heads(cuda, S, H, KV, D):
    """Causal prefill attention at musicgen-large's heads (32 / 32 of 64)
    and internvl2-26b's (48 / 8 of 128), against the plain version: 1e-3
    of max |out|."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(_bf16(rng, (1, S, n, D))).bfloat16()
               .to(cuda) for n in (H, KV, KV))
    got = pops.sliding_window_attention(q, k, v, window=S)
    want = pops.sliding_window_attention(q, k, v, window=S, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


def _dp_digests(tensors):
    import hashlib
    return [hashlib.sha256(t.detach().reshape(-1).cpu().view(torch.uint8)
                           .numpy()).hexdigest() for t in tensors]


def _dp_compressed(mesh, world):
    """Two compressed DP steps of qwen2.5-3b's width at 2 layers (a 4096
    vocabulary), one 256-token row a replica, on ``mesh``: the SHA-256 of
    every state leaf, of each residual slot, and the losses."""
    import dataclasses
    from repro_torch.data import pipeline as pdata
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import loop as ploop
    from repro_torch.train import optimizer as popt
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              vocab_size=4096)
    device = torch.device(mesh.device)
    params, opt = ploop.init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    ef = gc.init_error_feedback(mesh, params)
    batch = pdata.to_torch(pdata.batch_for_arch(cfg, 256, world, 0), device)
    step = gc.make_compressed_dp_train_step(
        mesh, ploop.make_loss_fn(cfg, "full"), popt.OptimizerConfig())
    losses = []
    for _ in range(2):
        params, opt, ef, m = step(params, opt, batch, ef)
        losses.append(float(m["loss_total"]))
    efs = list(popt.leaves(ef))
    return {"state": _dp_digests(list(popt.leaves(params))
                                 + list(popt.leaves(opt.mu))
                                 + list(popt.leaves(opt.nu)) + [opt.step]),
            "ef": [_dp_digests([e[r] for e in efs])
                   for r in range(efs[0].shape[0])],
            "losses": losses}


def _dp_rank(group):
    from repro_torch.sharding.mesh import make_local_mesh
    return _dp_compressed(make_local_mesh(group=group), group.world)


@pytest.mark.gpu
def test_cuda_compressed_dp_across_cards_equals_one_process(cards):
    """The int8 error-feedback DP step over NCCL ranks, one a card (at
    most four), equals the one-process step on ``TrainMesh(data=ranks)``
    on the first card bit for bit: params, moments and step, each rank's
    residual slot against its slot, the losses."""
    from repro_torch.sharding import dist
    from repro_torch.sharding.mesh import TrainMesh
    world = min(len(cards), 4)
    one = _dp_compressed(TrainMesh(data=world, device=str(cards[0])), world)
    torch.cuda.empty_cache()
    ranks = dist.spawn(_dp_rank, world, device="cuda", timeout_s=120,
                       join_timeout_s=600)
    for r, got in enumerate(ranks):
        assert got["state"] == one["state"]
        assert got["ef"] == [one["ef"][r]]
        assert got["losses"] == one["losses"]
