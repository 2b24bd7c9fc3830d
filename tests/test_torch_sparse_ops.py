"""The port's general sparse library against the reference.

* ``csc_encode`` / ``csc_decode``: the paper's scalar CSC, the same data,
  count and address vectors (runs of more than 15 zeros cut by explicit
  zeros at 4 count bits, and by more at 2), the same ``storage_bits`` and
  ``compression_ratio``, and an exact round trip;
* ``magnitude_prune``, ``prune_params`` and ``sparsity_stats`` on the
  reference's ``qwen2.5-3b-reduced`` weights: the same zeros, exactly;
* ``ops.bcsc_matmul`` / ``ops.bcsc_gemv`` (the plain versions here; the
  reference's Pallas kernels in interpret mode, as ``tests/test_kernels.py``
  runs them) at M 1, 8, 16 and 48, with bias and activation, forced tiles
  and a block-column with no block, fp32 inputs: within 1e-5 relative to
  max |out| (fp32 sums of the same products in another order); no CUDA
  launch is counted on the CPU;
* ``serve.sparse.packed_bytes`` equal to the reference's plus the bytes of
  the port's ``col_ptr`` segment starts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import sparsity as rsp
from repro.kernels import ops as rops
from repro.models import transformer as rtfm
from repro.serve import sparse as rsparse

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.core import sparsity as sp
from repro_torch.kernels import ops
from repro_torch.serve import sparse as psparse

ARCH = "qwen2.5-3b-reduced"
REL_TOL = 1e-5          # fp32 sums of the same products in another order


@pytest.fixture(scope="module")
def rparams():
    return rtfm.init_params(jax.random.PRNGKey(0), rget_config(ARCH))


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------- scalar CSC
def _sparse_matrix(rng, rows, cols, density):
    m = rng.standard_normal((rows, cols)).astype(np.float32)
    m[rng.random((rows, cols)) > density] = 0
    m[:, 1] = 0                        # an empty column
    m[3:40, 2] = 0                     # a run past two count overflows
    m[40, 2] = 1.5
    return m


@pytest.mark.parametrize("count_bits", [4, 2])
@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_csc_matches_reference(count_bits, density):
    m = _sparse_matrix(np.random.default_rng(5), 64, 12, density)
    mine = sp.csc_encode(m, count_bits)
    ref = rsp.csc_encode(m, count_bits)
    for field in ("data", "count", "address"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field))
        assert getattr(mine, field).dtype == getattr(ref, field).dtype
    assert (mine.nnz, mine.shape) == (ref.nnz, ref.shape)
    for bits in (8, 16):
        assert mine.storage_bits(bits) == ref.storage_bits(bits)
        assert mine.compression_ratio(bits) == ref.compression_ratio(bits)
    np.testing.assert_array_equal(sp.csc_decode(mine), m)
    assert (mine.count <= (1 << count_bits) - 1).all()
    assert int((mine.data == 0).sum()) > 0 or density == 1.0


# ------------------------------------------------------------------- pruning
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_magnitude_prune_matches_reference(sparsity):
    w = np.random.default_rng(2).standard_normal((96, 64)).astype(np.float32)
    got = sp.magnitude_prune(torch.from_numpy(w), sparsity)
    want = np.asarray(rsp.magnitude_prune(jnp.asarray(w), sparsity))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prune_params_and_stats_match_reference(rparams):
    ref = rsp.prune_params(rparams, 0.6, min_size=1024)
    mine = sp.prune_params(_to_torch(rparams), 0.6, min_size=1024)
    want = jax.tree.map(np.asarray, ref)
    got = jax.tree.map(lambda t: t.numpy(), mine)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    stats = sp.sparsity_stats(mine)
    assert stats == rsp.sparsity_stats(ref)
    assert 0.3 < stats["sparsity"] < 0.6          # the embedding unpruned


# ------------------------------------------------------------ bcsc_matmul
K, N = 64, 96


def _matrices(rng):
    w = rng.standard_normal((K, N)).astype(np.float32)
    w = np.array(rsp.block_magnitude_prune(jnp.asarray(w), 0.5, 16, 16))
    w[:, 32:48] = 0                    # a block-column with no block
    return rsp.bcsc_encode(w, 16, 16), sp.bcsc_encode(torch.from_numpy(w),
                                                      16, 16)


CASES = [  # M, bm, bias, activation
    (1, 0, False, None), (8, 0, True, "silu"), (16, 0, False, None),
    (48, 0, True, "gelu"), (5, 16, True, "relu"), (5, 8, False, "silu"),
    (20, 8, False, None), (48, 64, True, "silu"),
]


@pytest.mark.parametrize("M,bm,bias,act", CASES)
def test_bcsc_matmul_matches_reference(M, bm, bias, act):
    rng = np.random.default_rng(M + bm)
    rm, m = _matrices(rng)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    want = np.asarray(rops.bcsc_matmul(
        jnp.asarray(x), rm, bm=bm, activation=act,
        bias=None if b is None else jnp.asarray(b)))
    ops.reset_launches()
    got = ops.bcsc_matmul(torch.from_numpy(x), m, bm=bm, activation=act,
                          bias=None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    assert sum(ops.launch_counts().values()) == 0   # CPU: plain versions
    assert not got[:, 32:48].any() or bias


def test_bcsc_gemv_and_plan_routes():
    """``bcsc_gemv`` at M 8 equals the reference's; a plan's routes are
    taken when given (one that never takes the GEMV gives the same
    numbers through the GEMM arm); M 9 is refused."""
    rng = np.random.default_rng(3)
    rm, m = _matrices(rng)
    x = rng.standard_normal((8, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    want = np.asarray(rops.bcsc_gemv(jnp.asarray(x), rm, bias=jnp.asarray(b),
                                     activation="silu"))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    got = ops.bcsc_gemv(xt, m, bias=bt, activation="silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    plan = pplan.plan_for_scheduler(get_config(ARCH), rows=8, cache_len=64)
    gemm_only = pplan.ServePlan.from_dict(dict(plan.as_dict(), gemv_m_max=0))
    for p in (plan, gemm_only):
        np.testing.assert_allclose(
            ops.bcsc_matmul(xt, m, bias=bt, activation="silu",
                            plan=p).numpy(),
            want, rtol=0, atol=REL_TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="M<=8"):
        ops.bcsc_gemv(torch.zeros(9, K), m)
    blocks, rows, cols, n_out = ops.prepare_bcsc(m)
    r_blocks, r_rows, r_cols, r_n = rops.prepare_bcsc(rm)
    assert n_out == r_n
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(r_blocks))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(r_cols))


# ------------------------------------------------------------ packed bytes
def test_packed_bytes_matches_reference(rparams):
    rcfg, cfg = rget_config(ARCH), get_config(ARCH)
    rpacked, _ = rsparse.sparsify_mlp_params(rparams, rcfg, 0.5)
    packed, _ = psparse.sparsify_mlp_params(_to_torch(rparams), cfg, 0.5)
    col_ptr_bytes = 0

    def walk(tree):
        nonlocal col_ptr_bytes
        if ops.is_packed(tree):
            col_ptr_bytes += tree["col_ptr"].numel() * 4
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
    walk(packed)
    assert col_ptr_bytes > 0
    assert psparse.packed_bytes(packed) == \
        rsparse.packed_bytes(rpacked) + col_ptr_bytes
    assert psparse.packed_bytes(_to_torch(rparams)) == 0
