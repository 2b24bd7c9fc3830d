"""The port's single-device training against the reference on the CPU.

Inputs are numpy-seeded; weights are the port's ``init_params`` from a
seeded generator, given to both sides as numpy. The reference's programs
run compiled with XLA's excess precision off (``xla_allow_excess_precision``
False), which rounds every bf16 value where the program rounds it; they
are shared in module-scoped fixtures. Tolerances, and why:

* attention: the plain forward's log-sum-exp against ``flash._fwd_impl``
  within ``LSE_TOL`` (1e-5) of max |lse|, the plain backward's dq, dk, dv
  against ``flash._bwd_impl`` within ``BWD_TOL`` (1e-4) of each one's max
  |value| (the same block schedule and fp32 sums; a bf16 rounding of p or
  ds that an fp32 ulp of exp or tanh moves changes a block's product);
* the loss and its metrics within ``LOSS_TOL`` (1e-4) relative (1e-3 for
  the MoE configs, whose routers may part at near-ties);
* every gradient leaf within ``GRAD_TOL`` (2e-2) of its max |value| and
  ``GRAD_FRO_TOL`` (1e-2) in Frobenius norm: the backward rounds each
  product's cotangent to bf16, and an fp32 difference in the last bit of
  a sum (summation order, transcendental ulps) flips such a rounding by
  one bf16 step (2^-8 relative). The reference compiled with its default
  options differs from itself compiled strict by up to 1.5e-2 of max
  |grad| on ``qwen2.5-3b-reduced``;
* the same with the card's cotangent (``layers._cotangent`` rounding each
  product's fp32 cotangent to bf16 first): ``CARD_GRAD_FRO_TOL`` (2e-2)
  in Frobenius norm, since a bias's gradient (qwen's ``bk``, measured
  1.05e-2) sums a rounded cotangent over positions whose terms cancel;
* AdamW on the same grads: params, mu and nu within 1e-6 relative;
* three train steps: the first step's losses within ``LOSS_TOL`` (1e-3
  after it); after the first step each param leaf's distance from the
  reference's within ``STEP1_TOL`` (1e-4, measured 7.8e-6) of the
  reference's update, since both update from the same params and batch;
  after the third the whole tree's within ``STEP3_TOL`` (5e-2, measured
  8.0e-3) of the summed updates, and each element within the updates'
  own size (bf16 gradient noise moves Adam's normalised step where a
  gradient is near zero).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RCheckpointManager
from repro.configs import get_config as rget_config
from repro.data import pipeline as rdata
from repro.models import flash as rflash
from repro.models import transformer as rtfm
from repro.train import loop as rloop
from repro.train import optimizer as ropt

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import pipeline as pdata
from repro_torch.kernels import ops as pops
from repro_torch.launch import train as plaunch
from repro_torch.models import flash as pflash
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptfm
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Supervisor)
from repro_torch.train import loop as ploop
from repro_torch.train import optimizer as popt

LSE_TOL = 1e-5
BWD_TOL = 1e-4
LOSS_TOL = 1e-4
MOE_LOSS_TOL = 1e-3
GRAD_TOL = 2e-2
GRAD_FRO_TOL = 1e-2
CARD_GRAD_FRO_TOL = 2e-2
STEP1_TOL = 1e-4
STEP3_TOL = 5e-2
STRICT = {"xla_allow_excess_precision": False}
SEQ, BATCH = 64, 2
QWEN, GEMMA = "qwen2.5-3b-reduced", "gemma2-2b-reduced"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced models' ops are tiny; under the suite's parallel workers
    torch's intra-op threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(tree):
    """Copies: the port updates its params in place, and JAX may alias a
    numpy array's memory."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _init(arch, seed=0):
    """The port's seeded fp32 params and the same values as numpy."""
    params = ptfm.init_params(get_config(arch),
                              torch.Generator().manual_seed(seed), "cpu")
    return params, _numpy(params)


def _batch(arch, step=0, seq=SEQ, batch=BATCH):
    """A synthetic batch; patch and conditioning embeddings rounded to
    bf16 values (the port casts inputs of a product to bf16, the
    reference would multiply an fp32 one in fp32)."""
    b = rdata.batch_for_arch(rget_config(arch), seq, batch, step)
    for k in ("cond", "patch_embeds"):
        if k in b:
            b[k] = np.asarray(jnp.asarray(b[k], jnp.bfloat16), np.float32)
    return b


def _ref_value_and_grad(arch, params_np, batch, remat="none"):
    rcfg = rget_config(arch)
    vg = jax.value_and_grad(lambda p, b: rtfm.loss_fn(
        p, b, rcfg, remat_policy=remat), has_aux=True)
    (loss, metrics), grads = jax.jit(vg, compiler_options=STRICT)(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        dict(_paths(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def grad_cases():
    """Per arch: the port's params, a batch, and the reference's loss,
    metrics and gradients."""
    out = {}
    for arch, seq in ((QWEN, SEQ), (GEMMA, 80)):     # gemma2: S > window 32
        params, params_np = _init(arch)
        batch = _batch(arch, seq=seq)
        out[arch] = (params, batch) + _ref_value_and_grad(arch, params_np,
                                                          batch)
    return out


# ---------------------------------------------------------------- attention
def _bf16(rng, shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                      np.float32)


ATTN_CASES = {     # B, S, H, KV, D, mode, msize, softcap
    "causal R2": (1, 100, 4, 2, 32, "causal", 0, 0.0),
    "causal R1 block edge": (2, 48, 2, 2, 16, "causal", 0, 0.0),
    "window softcap R4": (2, 150, 4, 1, 64, "window", 40, 20.0),
    "window R2 S not of block": (1, 137, 4, 2, 32, "window", 50, 0.0),
    "chunk R3": (1, 200, 6, 2, 16, "chunk", 64, 0.0),
    "chunk softcap R1": (1, 90, 2, 2, 32, "chunk", 32, 30.0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_lse_and_backward_match_reference(case):
    """The plain forward's log-sum-exp against ``flash._fwd_impl``, and
    the plain backward (called through ``ops.flash_backward``) against
    ``flash._bwd_impl``, both called directly on the same bf16 inputs."""
    B, S, H, KV, D, mode, msize, softcap = ATTN_CASES[case]
    R = H // KV
    rng = np.random.default_rng(sum(map(ord, case)))
    q, do = _bf16(rng, (B, S, H, D)), _bf16(rng, (B, S, H, D))
    k, v = _bf16(rng, (B, S, KV, D)), _bf16(rng, (B, S, KV, D))
    blk = pops._swa.block_size(S)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)     # noqa: E731
    qf = bf(q).reshape(B, S, KV, R, D).transpose(0, 2, 3, 1, 4)
    kf, vf = bf(k).transpose(0, 2, 1, 3), bf(v).transpose(0, 2, 1, 3)
    qpos = jnp.arange(S, dtype=jnp.int32)
    statics = (mode, msize or S, softcap, blk, blk)
    out, lse = jax.jit(rflash._fwd_impl, static_argnums=(4, 5, 6, 7, 8))(
        qf, kf, vf, qpos, *statics)
    out16 = out.astype(jnp.bfloat16)
    dq, dk, dv = jax.jit(rflash._bwd_impl,
                         static_argnums=(7, 8, 9, 10, 11))(
        qf, kf, vf, qpos, out16, lse,
        bf(do).reshape(B, S, KV, R, D).transpose(0, 2, 3, 1, 4), *statics)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()  # noqa
    window = msize if mode == "window" else S
    chunk = msize if mode == "chunk" else 0
    _, got_lse = pops.sliding_window_attention(
        t(q), t(k), t(v), window=window, chunk=chunk, softcap=softcap,
        return_lse=True)
    want_lse = np.asarray(lse).transpose(0, 3, 1, 2).reshape(B, S, H)
    assert np.abs(got_lse.numpy() - want_lse).max() \
        <= LSE_TOL * np.abs(want_lse).max()

    o16 = np.asarray(out16.astype(jnp.float32)).transpose(
        0, 3, 1, 2, 4).reshape(B, S, H, D)
    got = pops.flash_backward(t(q), t(k), t(v), t(o16),
                              torch.from_numpy(want_lse.copy()), t(do),
                              window=window, chunk=chunk, softcap=softcap)
    want = (np.asarray(dq).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D),
            np.asarray(dk).transpose(0, 2, 1, 3),
            np.asarray(dv).transpose(0, 2, 1, 3))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= BWD_TOL, (name, err)


def test_flash_function_runs_the_backward_kernel_path():
    """``models.flash.flash_attention``'s gradients are
    ``ops.flash_backward`` of its saved output and log-sum-exp, in bf16,
    and its output is the plain forward's rounded to bf16."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_bf16(rng, s)).bfloat16().requires_grad_()
               for s in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16)))
    do = torch.from_numpy(_bf16(rng, (1, 40, 4, 16))).bfloat16()
    out = pflash.flash_attention(q, k, v, window=24, softcap=10.0)
    out.backward(do)
    want_out, lse = pops.sliding_window_attention(
        q.detach(), k.detach(), v.detach(), window=24, softcap=10.0,
        return_lse=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want_out.bfloat16())
    want = pops.flash_backward(q.detach(), k.detach(), v.detach(),
                               out.detach(), lse, do, window=24,
                               softcap=10.0)
    for t, w in zip((q, k, v), want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, w.bfloat16())


# ------------------------------------------------------------ loss and grads
def _port_value_and_grad(arch, params, batch, remat="none"):
    for p in popt.leaves(params):
        p.grad = None
        p.requires_grad_(True)
    loss, metrics = ptfm.loss_fn(params, pdata.to_torch(batch),
                                 get_config(arch), remat_policy=remat)
    loss.backward()
    grads = {name: p.grad.numpy().copy() for name, p in _paths(params)}
    for p in popt.leaves(params):
        p.requires_grad_(False)
        p.grad = None
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def _assert_grads_close(got, want, fro_tol=GRAD_FRO_TOL):
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max() / scale
        fro = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_TOL and fro <= fro_tol, (name, err, fro)


@pytest.mark.parametrize("arch", [QWEN, GEMMA])
def test_loss_and_gradients_match_reference(grad_cases, arch):
    """``loss_fn``'s value, metrics and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; gemma2 at 80
    positions runs window-mode attention (window 32), its attention and
    final softcaps and post-norms."""
    params, batch, rloss, rmetrics, rgrads = grad_cases[arch]
    loss, metrics, grads = _port_value_and_grad(arch, params, batch)
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_TOL)
    for k, v in rmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_TOL,
                                   atol=1e-7)
    _assert_grads_close(grads, rgrads)


@pytest.mark.parametrize("arch", [QWEN, GEMMA])
def test_gradients_with_the_cards_cotangent_match_reference(
        grad_cases, arch, monkeypatch):
    """The products' backward as the card runs it: ``layers._cotangent``
    made to round every fp32 cotangent to bf16, as it does for a CUDA
    tensor, and the loss and every gradient leaf held against the
    reference's as above (``CARD_GRAD_FRO_TOL`` in Frobenius norm)."""
    monkeypatch.setattr(players, "_cotangent",
                        lambda g: g.to(players.COMPUTE_DTYPE))
    params, batch, rloss, _, rgrads = grad_cases[arch]
    loss, _, grads = _port_value_and_grad(arch, params, batch)
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_TOL)
    _assert_grads_close(grads, rgrads, fro_tol=CARD_GRAD_FRO_TOL)


OTHER_ARCHS = ("recurrentgemma-2b-reduced", "mamba2-130m-reduced",
               "mixtral-8x7b-reduced", "llama4-maverick-400b-a17b-reduced",
               "musicgen-large-reduced", "internvl2-26b-reduced")


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_loss_matches_reference_other_archs(arch):
    """The loss value of the recurrent, MoE and frontend configs (K
    codebook labels for musicgen, patches for internvl2, the MoE aux
    loss) against the reference's, through the training path (params
    recording gradients). An MoE router may send a token whose top
    experts' scores nearly tie to another expert than the reference's
    does (``tests/test_torch_moe.py``): for the MoE configs the loss is
    held within ``MOE_LOSS_TOL`` (1e-3) and the aux loss within one
    token's move, 2·E / (B·S) (it is E · sum over experts of the mean
    router probability times the share of tokens routed there)."""
    params, params_np = _init(arch, seed=1)
    B, S = BATCH, 48
    batch = _batch(arch, seq=S)
    rcfg = rget_config(arch)
    rloss, rmetrics = jax.jit(lambda p, b: rtfm.loss_fn(p, b, rcfg),
                              compiler_options=STRICT)(
        jax.tree.map(jnp.asarray, params_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for p in popt.leaves(params):
        p.requires_grad_(True)
    loss, metrics = ptfm.loss_fn(params, pdata.to_torch(batch),
                                 get_config(arch))
    assert loss.requires_grad
    moe = bool(rcfg.moe)
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=MOE_LOSS_TOL if moe else LOSS_TOL)
    np.testing.assert_allclose(
        float(metrics["moe_aux"].detach()), float(rmetrics["moe_aux"]),
        rtol=0, atol=2 * rcfg.num_experts / (B * S) if moe else 0.0)


# ---------------------------------------------------------------- optimizer
def test_adamw_matches_reference():
    """Three ``adamw_update`` steps on the same numpy grads (one with a
    norm past the clip, weight decay on the matrices only)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (8, 6), "b": (6,), "blocks": {"u": (2, 4, 4)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}
    p_np = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    cfg = popt.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=5)
    rcfg = ropt.OptimizerConfig(**dataclasses.asdict(cfg))
    rp = jax.tree.map(jnp.asarray, p_np)
    rs = ropt.init_adamw(rp)
    pp = bridge.params_from_numpy(p_np)
    ps = popt.init_adamw(pp)
    for i in range(3):
        g_np = tree(lambda s: (rng.standard_normal(s) * (4.0 if i == 1
                                                         else 0.05))
                    .astype(np.float32))
        rp, rs, rm = jax.jit(ropt.adamw_update, static_argnums=0)(
            rcfg, rp, jax.tree.map(jnp.asarray, g_np), rs)
        pp, ps, pm = popt.adamw_update(cfg, pp, bridge.params_from_numpy(
            g_np), ps)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)
    assert int(ps.step) == int(rs.step) == 3
    for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
        for (name, a), (_, b) in zip(_paths(got), _paths(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=name)


def test_schedule_and_clipping_match_reference():
    cfg = popt.OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                               total_steps=100, min_lr_ratio=0.1)
    rcfg = ropt.OptimizerConfig(**dataclasses.asdict(cfg))
    for s in (0, 5, 10, 50, 100, 150):
        np.testing.assert_allclose(
            float(popt.cosine_schedule(cfg, torch.tensor(s))),
            float(ropt.cosine_schedule(rcfg, jnp.int32(s))), rtol=1e-6)
    g = {"a": np.full((10,), 100.0, np.float32),
         "b": np.arange(6, dtype=np.float32)}
    clipped, norm = popt.clip_by_global_norm(bridge.params_from_numpy(g),
                                             1.0)
    rclipped, rnorm = ropt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    np.testing.assert_allclose(float(popt.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(rclipped[k]), rtol=1e-6)


# ---------------------------------------------------------------- train step
def test_train_steps_match_reference():
    """Three ``make_train_step`` steps (remat "dots", the reference's
    default) against the reference's on the same params and batches: the
    first step's metrics within ``LOSS_TOL``, the later ones within 1e-3
    (the params have parted by the updates' bf16 noise by then); the
    params against the reference's updates (``STEP1_TOL``, ``STEP3_TOL``)."""
    params, params_np = _init(QWEN, seed=2)
    start = dict(_paths(params_np))

    def distances():
        """Per leaf: |port - ref| and |ref - start| (Frobenius)."""
        return {name: (np.linalg.norm(a.numpy() - b),
                       np.linalg.norm(b - start[name]))
                for (name, a), (_, b) in zip(_paths(params), _paths(
                    jax.tree.map(np.asarray, rp)))}
    ocfg = popt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    rstep = jax.jit(rloop.make_train_step(
        rget_config(QWEN), ropt.OptimizerConfig(**dataclasses.asdict(ocfg))),
        compiler_options=STRICT)
    pstep = ploop.make_train_step(get_config(QWEN), ocfg)
    rp = jax.tree.map(jnp.asarray, params_np)
    rs = ropt.init_adamw(rp)
    ps = popt.init_adamw(params)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(QWEN, step=i, seq=32)
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        params, ps, pm = pstep(params, ps, pdata.to_torch(batch))
        for k in ("loss", "loss_total", "z_loss", "accuracy", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=LOSS_TOL if i == 0 else 1e-3,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-2)
        lr_sum += float(rm["lr"])
        if i == 0:
            for name, (off, update) in distances().items():
                assert off <= STEP1_TOL * update, (name, off, update)
    off, update = np.sqrt(np.sum(np.square(list(distances().values())), 0))
    assert off <= STEP3_TOL * update, (off, update)
    # an Adam step moves each element by at most ~lr (m / sqrt(v) <= 1 in
    # size, plus decay); where a gradient sits in bf16 noise its sign may
    # differ, so elements may differ by up to twice the summed steps
    for (name, a), (_, b) in zip(_paths(params), _paths(
            jax.tree.map(np.asarray, rp))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2.2 * lr_sum, err_msg=name)


def _step_once(arch, policy="none", microbatches=1, seq=32, batch=4):
    params, _ = _init(arch)
    ocfg = popt.OptimizerConfig(warmup_steps=0, total_steps=10)
    step = ploop.make_train_step(get_config(arch), ocfg, remat_policy=policy,
                                 microbatches=microbatches)
    b = pdata.to_torch(_batch(arch, seq=seq, batch=batch))
    params, _, metrics = step(params, popt.init_adamw(params), b)
    return params, metrics


def test_microbatches_equal_one():
    """mb=2 gives the updated params of mb=1 (the reference's own
    invariant, ``tests/test_train.py``, at its tolerances)."""
    p1, m1 = _step_once(QWEN, microbatches=1)
    p2, m2 = _step_once(QWEN, microbatches=2)
    np.testing.assert_allclose(float(m1["loss_total"]),
                               float(m2["loss_total"]), rtol=2e-2)
    for a, b in zip(popt.leaves(p1), popt.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-3)


def test_remat_policies_give_the_same_loss_and_grads():
    """"full", "dots" and "dots_no_batch" recompute the forward in the
    backward: the same loss and gradients as "none", bit for bit on the
    CPU (the same operations on the same values)."""
    params, _ = _init(QWEN)
    batch = _batch(QWEN, seq=32)
    want = _port_value_and_grad(QWEN, params, batch, "none")
    for policy in ("full", "dots", "dots_no_batch"):
        got = _port_value_and_grad(QWEN, params, batch, policy)
        assert got[0] == want[0], policy
        for name in want[2]:
            np.testing.assert_array_equal(got[2][name], want[2][name],
                                          err_msg=f"{policy} {name}")


def test_remat_matches_reference_gradients(grad_cases):
    """remat "full" against the reference's remat-free gradients."""
    params, batch, rloss, _, rgrads = grad_cases[QWEN]
    loss, _, grads = _port_value_and_grad(QWEN, params, batch, "full")
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_TOL)
    _assert_grads_close(grads, rgrads)


def test_loss_decreases_when_memorizing():
    """A few steps on one repeated batch reduce the loss (the reference's
    own invariant at its geometry: gemma2-2b-reduced, 32 x 2)."""
    arch = GEMMA
    params, _ = _init(arch)
    ocfg = popt.OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=40)
    step = ploop.make_train_step(get_config(arch), ocfg)
    opt = popt.init_adamw(params)
    batch = pdata.to_torch(_batch(arch, seq=32, batch=2))
    first = None
    for _ in range(12):
        params, opt, metrics = step(params, opt, batch)
        first = float(metrics["loss"]) if first is None else first
    assert float(metrics["loss"]) < first * 0.9, (first,
                                                  float(metrics["loss"]))


def test_eval_step_matches_loss_fn():
    params, _ = _init(QWEN)
    batch = pdata.to_torch(_batch(QWEN, seq=32))
    got = ploop.make_eval_step(get_config(QWEN))(params, batch)
    loss, metrics = ptfm.loss_fn(params, batch, get_config(QWEN))
    assert not got["loss_total"].requires_grad
    assert float(got["loss_total"]) == float(loss)
    assert float(got["loss"]) == float(metrics["loss"])


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen2.5-3b-reduced",
                                  "musicgen-large-reduced",
                                  "internvl2-26b-reduced"])
def test_synth_batch_bit_equal(arch):
    for step in (0, 7):
        want = rdata.batch_for_arch(rget_config(arch), 40, 4, step, seed=3)
        got = pdata.batch_for_arch(get_config(arch), 40, 4, step, seed=3)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    cfg = pdata.DataConfig(seq_len=16, global_batch=4, vocab_size=100,
                           num_hosts=2, host_id=1)
    rcfg = rdata.DataConfig(**dataclasses.asdict(cfg))
    np.testing.assert_array_equal(pdata.synth_batch(cfg, 3)["tokens"],
                                  rdata.synth_batch(rcfg, 3)["tokens"])


def test_pipeline_resumes_from_any_step():
    cfg = pdata.DataConfig(seq_len=8, global_batch=2, vocab_size=50)
    pipe = pdata.Pipeline(cfg, start_step=5)
    try:
        steps = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    assert [s for s, _ in steps] == [5, 6, 7] and pipe.step == 8
    for s, b in steps:
        np.testing.assert_array_equal(b["tokens"],
                                      pdata.synth_batch(cfg, s)["tokens"])


# -------------------------------------------------------------- checkpoints
def test_checkpoints_cross_between_packages(tmp_path):
    """A (params, AdamWState) checkpoint written by the port restores in
    the reference, and one the reference writes restores in the port:
    same files, same flattened keys, same values."""
    params, params_np = _init(QWEN)
    state = (params, popt.init_adamw(params))
    state[1].mu["embed"].fill_(0.5)
    state = (state[0], state[1]._replace(step=torch.tensor(
        7, dtype=torch.int32)))
    pdir, rdir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(pdir).save(3, state, extra={"who": "port"})
    rtarget = (jax.tree.map(jnp.asarray, params_np),
               ropt.init_adamw(jax.tree.map(jnp.asarray, params_np)))
    rstate, manifest = RCheckpointManager(pdir).restore(rtarget)
    assert manifest["extra"] == {"who": "port"} and manifest["step"] == 3
    assert int(rstate[1].step) == 7
    np.testing.assert_array_equal(np.asarray(rstate[1].mu["embed"]), 0.5)
    np.testing.assert_array_equal(np.asarray(rstate[0]["embed"]),
                                  params_np["embed"])

    RCheckpointManager(rdir).save(4, rstate)
    with open(os.path.join(rdir, "step_00000004", "manifest.json")) as f:
        rkeys = json.load(f)["keys"]
    with open(os.path.join(pdir, "step_00000003", "manifest.json")) as f:
        assert json.load(f)["keys"] == rkeys
    got, manifest = CheckpointManager(rdir).restore(
        (params, popt.init_adamw(params)))
    assert manifest["step"] == 4 and int(got[1].step) == 7
    assert isinstance(got[1], popt.AdamWState)
    for (_, a), (_, b) in zip(_paths(got[0]), _paths(params)):
        assert torch.equal(a, b)
    assert torch.equal(got[1].mu["embed"], state[1].mu["embed"])


def test_checkpoint_retention_and_shape_check(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.ones(4, 4), "step": torch.tensor(0)}
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    assert mgr.steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(5, 5), "step": torch.tensor(0)})
    meta = {"w": torch.empty(4, 4, device="meta"), "step": torch.tensor(0)}
    restored, _ = mgr.restore(meta)
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], torch.ones(4, 4))


def test_bridge_carries_a_train_state_both_ways():
    params, params_np = _init(QWEN)
    rstate = (jax.tree.map(jnp.asarray, params_np),
              ropt.init_adamw(jax.tree.map(jnp.asarray, params_np)))
    got = bridge.train_state_from_numpy(jax.tree.map(np.asarray, rstate))
    assert isinstance(got[1], popt.AdamWState)
    assert got[1].step.dtype == torch.int32
    back = bridge.train_state_to_numpy(got)
    again = ropt.AdamWState(*back[1])
    assert int(again.step) == 0
    for (_, a), (_, b) in zip(_paths(back[0]), _paths(params_np)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- supervisor
def test_supervisor_restarts_after_injected_failure(tmp_path):
    fired = {"done": False}

    def step_fn(state, batch):
        return state + batch, {"loss": float(state)}

    def failure_injector(step, attempt):
        if step == 5 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    beat = str(tmp_path / "heartbeat.json")
    sup = Supervisor(
        FaultToleranceConfig(checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=2, max_retries=2,
                             backoff_s=0.0, heartbeat_path=beat),
        step_fn=step_fn, data_fn=lambda step: torch.tensor(1.0),
        init_state_fn=lambda: torch.tensor(0.0),
        failure_injector=failure_injector)
    result = sup.run(10)
    assert result["restarts"] == 1
    assert result["final_step"] == 9
    # the replayed run gives the same final state as a clean one
    assert float(sup.ckpt.restore(torch.tensor(0.0))[0]) == 10.0
    with open(beat) as f:
        rec = json.load(f)
    assert rec["step"] == 9 and rec["restarts"] == 1
    assert rec["schema"] == "repro.telemetry/heartbeat-v1"


def test_supervisor_retry_budget_exhausts(tmp_path):
    def always_fail(state, batch):
        raise RuntimeError("dead node")

    sup = Supervisor(
        FaultToleranceConfig(checkpoint_dir=str(tmp_path), max_retries=2,
                             backoff_s=0.0),
        step_fn=always_fail, data_fn=lambda s: 0,
        init_state_fn=lambda: torch.tensor(0.0))
    with pytest.raises(RuntimeError, match="retry budget"):
        sup.run(3)
    assert sup.restarts == 3


# ------------------------------------------------------------------- launch
def test_launch_train_on_the_cpu(tmp_path, capsys):
    """The CLI on a ``-reduced`` config: steps, checkpoints, a second run
    resuming from the last checkpoint."""
    args = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    result = plaunch.main(args)
    assert [m["step"] for m in result["metrics"]] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in result["metrics"])
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "restarts=0" in out
    again = plaunch.main(args[:6] + ["4"] + args[7:])
    assert [m["step"] for m in again["metrics"]] == [3]
