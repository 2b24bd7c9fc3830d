"""The port against the reference on ``mistral-nemo-12b-reduced``: global
attention only (GQA, 4 query heads per KV head in the reduced config),
RoPE theta 1 000 000, SwiGLU MLPs and an untied ``lm_head``.

Reference parameters come from ``transformer.init_params(PRNGKey(0), cfg)``
(MLPs packed at 0.5 where stated), bridged to the port as numpy. A second
variant breaks what the reduced config and the zero-initialised norms hide:
``head_dim`` 24 on both sides (``d_model`` 64 != heads x head_dim, as in
the full model's 5120 against 32 x 128) with every norm scale drawn N(0,
0.5) from a seeded numpy generator.

Logits are held to 1e-2 of max |logit| (fp32 sums in another order flip
bf16 roundings, which the layers carry forward). Greedy agreement is
asserted token for token; where an argmax or a stream parts, the
reference's own top-2 margin there must be below that 1e-2 (a near-tie of
an untrained model: the variant has one in its 32 teacher-forced steps),
and the stream is compared no further (``torch_dense_parity``).
"""
import numpy as np
import pytest

import torch_dense_parity as par

from repro_torch.configs import get_config
from repro_torch.core.plan import num_global_layers
from repro_torch.models import transformer as ptfm

ARCH = "mistral-nemo-12b-reduced"
LENGTHS, TIER, CACHE, PS = [40, 61, 9], 64, 96, 8
STEPS = 32


@pytest.fixture(scope="module")
def cases():
    return {"base": par.make_case(ARCH),
            "head_dim 24, norms drawn": par.make_case(ARCH, head_dim=24,
                                                       norm_seed=1)}


def test_full_size_layout():
    """The full config: 40 global layers (one slot, 40 periods) at RoPE
    theta 1 000 000, d_model 5120 against 32 heads of 128, an untied head,
    12.25 B parameters."""
    cfg = get_config("mistral-nemo-12b")
    assert ptfm.slot_names(cfg) == [("slot0", "global")]
    assert ptfm.num_scan_periods(cfg) == 40 == num_global_layers(cfg)
    assert ptfm._rope_theta_for(cfg, "global") == 1_000_000.0
    assert cfg.d_model == 5120 != cfg.num_heads * cfg.head_dim
    assert not cfg.tie_embeddings and not cfg.qk_norm
    assert round(cfg.param_count() / 1e9, 2) == 12.25


@pytest.mark.parametrize("which", [0, 1, 2])
def test_full_size_plans_match_reference(which):
    """Plan parity at full size (rows 8, cache 4096): the scheduler's plan
    on paged fp and int8 KV and the drain engine's, field for field; the
    fused MLP takes M <= 32 (4 bm (2 d_ff + d) fits 8 MiB up to bm 62)."""
    want, mine = par.full_plans("mistral-nemo-12b", 8, 4096)[which]
    par.plan_fields_equal(mine, want)
    assert mine["mlp_fused_m_max"] == 32


@pytest.mark.parametrize("variant,paged,sparsity", [
    ("base", True, None), ("base", True, 0.5), ("base", False, None),
    ("head_dim 24, norms drawn", True, None),
    ("head_dim 24, norms drawn", False, 0.5)])
def test_prefill_and_decode_match_reference(cases, variant, paged, sparsity):
    """Prefill at tier 64, then 32 teacher-forced decode steps, paged and
    contiguous: logits within 1e-2 of max |logit|, greedy tokens equal or
    a reference tie."""
    pre, steps = par.logits_errors(cases[variant], sparsity, paged,
                                      LENGTHS, TIER, CACHE, PS, STEPS)
    assert pre < par.LOGIT_TOL and max(steps) < par.LOGIT_TOL


@pytest.mark.parametrize("variant", ["base", "head_dim 24, norms drawn"])
def test_paged_equals_contiguous_and_packed_zero_equals_dense(cases,
                                                              variant):
    par.paged_contiguous_packed_invariants(cases[variant], LENGTHS, TIER,
                                           CACHE, PS, 8)


# ------------------------------------------------------------------ serving
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(2, 503, n)]
           for i, n in enumerate((5, 60, 33, 17))]
STAGGERED = dict(rows=2, cache_len=CACHE, page_size=PS, sync_every=4)
PREEMPTION = dict(rows=3, cache_len=CACHE, page_size=PS, num_pages=16,
                  sync_every=4)


@pytest.mark.parametrize("variant,geometry,arrivals,kv_quant", [
    ("base", STAGGERED, [0.0, 0.0, 6.0, 13.0], "fp"),
    ("base", PREEMPTION, None, "int8"),
    ("head_dim 24, norms drawn", STAGGERED, [0.0, 0.0, 6.0, 13.0], "fp"),
    ("head_dim 24, norms drawn", PREEMPTION, None, "int8")])
def test_stream_matches_reference(cases, variant, geometry, arrivals,
                                  kv_quant):
    """Greedy ``LLM.stream`` (CPU, MLPs packed at 0.5) against the
    reference scheduler on fp and int8 pools, request by request (a
    parting only at a tie), with the same admission, first-token and
    finish steps."""
    st = par.stream_vs_reference(cases[variant], PROMPTS, 40, geometry,
                                    arrivals, kv_quant)
    if geometry is PREEMPTION:
        assert st["preemptions"] > 0


@pytest.mark.parametrize("variant", ["base", "head_dim 24, norms drawn"])
def test_generate_matches_reference_engine(cases, variant):
    """Greedy ``LLM.generate`` (the drain engine, 2 slots) against the
    reference ``DecodeEngine``."""
    par.generate_vs_reference(cases[variant], PROMPTS, [40, 30, 40, 40],
                              slots=2, cache_len=CACHE, sync_every=4)
