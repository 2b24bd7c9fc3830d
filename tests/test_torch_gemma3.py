"""The port against the reference on ``gemma3-12b-reduced``: five local
(sliding-window, window 32) layers to one global, qk-norm before RoPE, a
RoPE theta of 10 000 in the local layers and 1 000 000 in the global ones,
sandwich post-norms, GeGLU MLPs, tied embeddings, no softcaps.

Reference parameters come from ``transformer.init_params(PRNGKey(0), cfg)``
(MLPs packed at 0.5 where stated), bridged to the port as numpy. Prompts
are longer than the window (tier 64 > 32), so prefill runs the window mode
of the sliding-window attention in the local layers, and decode runs 32
steps, so every local ring wraps. Two variants break what the reduced
config and the zero-initialised norms hide: ``head_dim`` 24 on both sides
(``d_model`` 64 != heads x head_dim, as in the full model's 3840 against
16 x 256) with every norm scale, ``q_norm`` and ``k_norm`` among them,
drawn N(0, 0.5) from a seeded numpy generator.

Logits are held to 1e-2 of max |logit| (fp32 sums in another order flip
bf16 roundings, which the layers carry forward). Greedy agreement is
asserted token for token; where an argmax or a stream parts, the
reference's own top-2 margin there must be below that 1e-2 (a near-tie of
an untrained model), and the stream is compared no further
(``torch_dense_parity``). A control gives the port ``local_rope_theta =
rope_theta``: its logits must then miss the reference's by far more than
the tolerance, which shows that the comparison sees the local theta.
"""
import dataclasses

import numpy as np
import pytest

import torch_dense_parity as par

from repro_torch.configs import get_config
from repro_torch.core.plan import num_global_layers
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptfm

ARCH = "gemma3-12b-reduced"
LENGTHS, TIER, CACHE, PS = [40, 61, 9], 64, 96, 8
STEPS = 32           # positions 40..71, 61..92 and 9..40: every ring wraps


@pytest.fixture(scope="module")
def cases():
    return {"base": par.make_case(ARCH),
            "head_dim 24, norms drawn": par.make_case(ARCH, head_dim=24,
                                                       norm_seed=1)}


def test_full_size_layout():
    """The full config: 6 slots (five local, one global) over 8 periods,
    theta 10 000 in the local slots and 1 000 000 in the global one, 8
    global layers in the paged pool, and a ring of min(window, cache_len)
    = 1024 slots in each of the 40 local layers, paged or contiguous."""
    cfg = get_config("gemma3-12b")
    slots = ptfm.slot_names(cfg)
    assert [k for _, k in slots] == ["local"] * 5 + ["global"]
    assert ptfm.scan_period(cfg) == 6 and ptfm.num_scan_periods(cfg) == 8
    assert [ptfm._rope_theta_for(cfg, k) for _, k in slots] \
        == [10_000.0] * 5 + [1_000_000.0]
    assert num_global_layers(cfg) == 8
    assert cfg.d_model != cfg.num_heads * cfg.head_dim
    for cache in (pdec.init_paged_cache(cfg, 4, 8192, 512, 64,
                                        device="meta"),
                  pdec.init_cache(cfg, 4, 8192, device="meta")):
        rings = [cache["blocks"][n]["k"] for n, k in slots if k == "local"]
        assert sum(r.shape[0] for r in rings) == 40
        assert all(tuple(r.shape) == (8, 4, 1024, 8, 256) for r in rings)
    pool = pdec.init_paged_cache(cfg, 4, 8192, 512, 64, "int8",
                                 device="meta")["blocks"]["slot5"]
    assert tuple(pool["pk"].shape) == (8, 512, 64, 8, 256)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_full_size_plans_match_reference(which):
    """Plan parity at full size (rows 4, cache 8192): the scheduler's plan
    on paged fp and int8 KV and the drain engine's, field for field; the
    fused MLP takes M <= 32 (4 bm (2 d_ff + d) fits 8 MiB up to bm 60)."""
    want, mine = par.full_plans("gemma3-12b", 4, 8192)[which]
    par.plan_fields_equal(mine, want)
    assert mine["mlp_fused_m_max"] == 32


@pytest.mark.parametrize("variant,paged,sparsity", [
    ("base", True, 0.5), ("base", False, None),
    ("head_dim 24, norms drawn", True, None)])
def test_prefill_and_decode_match_reference(cases, variant, paged, sparsity):
    """Prefill at tier 64 (window mode in the local layers), then 32
    decode steps across every ring's wrap, paged and contiguous: logits
    within 1e-2 of max |logit|, greedy tokens equal or a reference tie."""
    pre, steps = par.logits_errors(cases[variant], sparsity, paged,
                                      LENGTHS, TIER, CACHE, PS, STEPS)
    assert pre < par.LOGIT_TOL and max(steps) < par.LOGIT_TOL


def test_local_rope_theta_control(cases):
    """The port given ``local_rope_theta = rope_theta`` (the reference
    keeps 10 000): prefill and decode logits miss by more than five times
    the tolerance, so the comparison above sees the local theta."""
    case = cases["base"]
    wrong = dataclasses.replace(case.cfg, local_rope_theta=case.cfg.rope_theta)
    pre, steps = par.logits_errors(case, None, True, LENGTHS, TIER, CACHE,
                                      PS, STEPS, port_cfg=wrong)
    assert pre > 5 * par.LOGIT_TOL and max(steps) > 5 * par.LOGIT_TOL


def test_paged_equals_contiguous_and_packed_zero_equals_dense(cases):
    par.paged_contiguous_packed_invariants(cases["head_dim 24, norms drawn"],
                                           LENGTHS, TIER, CACHE, PS, 8)


# ------------------------------------------------------------------ serving
# prompts of 33-60 tokens (one prefill tier, which keeps the reference's
# compiles few), all past the 32-token window; prompt + max_new fills up
# to the 96-token cache
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(2, 503, n)]
           for i, n in enumerate((40, 60, 33, 50))]
STAGGERED = dict(rows=2, cache_len=CACHE, page_size=PS, sync_every=4)
PREEMPTION = dict(rows=3, cache_len=CACHE, page_size=PS, num_pages=16,
                  sync_every=4)


@pytest.mark.parametrize("geometry,arrivals,kv_quant,max_new", [
    (STAGGERED, [0.0, 0.0, 6.0, 13.0], "fp", 32),
    (PREEMPTION, None, "int8", 16)])
def test_stream_matches_reference(cases, geometry, arrivals, kv_quant,
                                  max_new):
    """Greedy ``LLM.stream`` (CPU, MLPs packed at 0.5) against the
    reference scheduler on fp and int8 pools, request by request (a parting
    only at a tie), with the same admission, first-token and finish
    steps."""
    st = par.stream_vs_reference(cases["base"], PROMPTS, max_new,
                                    geometry, arrivals, kv_quant)
    if geometry is PREEMPTION:
        assert st["preemptions"] > 0


def test_generate_matches_reference_engine(cases):
    """Greedy ``LLM.generate`` (the drain engine, 2 slots, budgets past the
    window) against the reference ``DecodeEngine``, at head_dim 24 with
    the norm scales drawn."""
    par.generate_vs_reference(cases["head_dim 24, norms drawn"], PROMPTS,
                              [40, 30, 40, 40],
                              slots=2, cache_len=CACHE, sync_every=4)
