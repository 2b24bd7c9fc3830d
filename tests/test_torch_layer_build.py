"""The layer-at-a-time build of a packed params tree on the CPU
(``serve.sparse.build_sparse_params``), and the bytes of internvl2-26b's
served tree at published width and depth.

``build_sparse_params(cfg, seed, sparsity)`` draws each layer from its own
generator, packs and casts it, and writes it into the stacked tree, so only
one layer's fp32 values are ever alive. It must give, bit for bit and leaf
for leaf (keys in order, shapes, dtypes, bits), what the whole-tree pipeline
gives for the fp32 tree of the same per-layer draws:
``compute_copy(sparsify_mlp_params(draw_params(cfg, seed), cfg,
sparsity))``, with the same stats. The configs: the two frontends' reduced
sizes, recurrentgemma (two remainder layers beside its stacked periods, an
RG-LRU slot) and qwen2.5-3b at sparsity 0 (every MLP left dense, cast to
bf16). Needs neither JAX nor the reference package.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.models import transformer as ptfm
from repro_torch.serve import sparse as psparse


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


def _bits(t):
    return t.reshape(-1).view(torch.uint8) if t.dtype.is_floating_point \
        else t.reshape(-1)


@pytest.mark.parametrize("arch,sparsity", [
    ("internvl2-26b-reduced", 0.75),
    ("musicgen-large-reduced", 0.75),
    ("recurrentgemma-2b-reduced", 0.75),
    ("qwen2.5-3b-reduced", 0.0),
])
def test_layer_build_equals_whole_tree_pipeline(arch, sparsity):
    cfg = get_config(arch)
    got, got_stats = psparse.build_sparse_params(cfg, 5, sparsity,
                                                      device="cpu")
    want, want_stats = psparse.sparsify_mlp_params(
        psparse.draw_params(cfg, 5, "cpu"), cfg, sparsity)
    want = ptfm.compute_copy(want)
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, key
        assert torch.equal(_bits(g), _bits(w)), key
    assert got_stats == want_stats
    if sparsity:
        assert got_stats["packed"] and not got_stats["left_dense"]
        assert any(k.endswith("_bcsc_counts") for k, _ in got)
    else:
        assert got_stats["left_dense"] and not got_stats["packed"]
        assert all(v.dtype == torch.bfloat16 for k, v in got
                   if k.split("/")[-1] in ("wg", "wu", "wd"))
    if ptfm.num_remainder(cfg):
        assert "rem/rem0/mlp/_bcsc_counts" in dict(got)


def test_layer_draws_are_their_own():
    """Each layer's draw depends only on (seed, layer): layer 1 of a
    4-layer config equals layer 1 of the 2-layer one, the stacked tree's
    period i is layer i's draw, and another seed draws other values."""
    cfg = get_config("internvl2-26b-reduced")
    short = dataclasses.replace(cfg, num_layers=2)
    a = psparse.draw_layer(cfg, 3, 1, "cpu")
    b = psparse.draw_layer(short, 3, 1, "cpu")
    for (_, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    tree = psparse.draw_params(cfg, 3, "cpu")
    assert torch.equal(tree["blocks"]["slot0"]["attn"]["wq"][1],
                       a["attn"]["wq"])
    other = psparse.draw_layer(cfg, 4, 1, "cpu")
    assert not torch.equal(other["attn"]["wq"], a["attn"]["wq"])


def test_layer_build_defaults_to_the_card(monkeypatch):
    """Without ``device`` the build is on the card, as every entry point
    of the port is: with no CUDA it raises rather than build the tree in
    host memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psparse.build_sparse_params(get_config("internvl2-26b-reduced"), 5,
                                    0.75)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def _served_bytes(leaves, layers: int, kept, block=(16, 16)):
    """Bytes of ``leaves`` (a meta tree's, divided over ``layers``
    stacked layers where stacked) as served: weight matrices in bf16
    (``transformer.compute_copy``), norms fp32, each MLP weight packed
    into ``kept(name, blocks)`` payload blocks a layer (bf16 payload, int32
    row and column ids a block, ``nnzb``, ``col_ptr``) and each packed MLP
    with its (3,) int32 ``_bcsc_counts`` a layer."""
    bk, bn = block
    total = 0
    for key, t in leaves:
        n = t.numel() // layers
        name = key.split("/")[-1]
        if "/mlp/" in key:
            nb = (t.shape[-2] // bk) * (t.shape[-1] // bn)
            total += kept(name, nb) * (bk * bn * 2 + 4 + 4) + 4 \
                + (t.shape[-1] // bn + 1) * 4
            total += 3 * 4 if name == "wd" else 0
        elif name in ptfm.MATRIX_KEYS:
            total += n * 2
        else:
            total += n * 4
    return total


def test_internvl2_full_depth_tree_fits_one_card():
    """internvl2-26b's served tree at its published 48 layers. The
    reckoning (``_served_bytes`` of a meta tree) is first held, byte for
    byte, to what ``build_sparse_params`` builds for the 2-layer reduced
    config with its own block counts, so a change to the served layout
    (payload or id dtypes, padding, casts, counts) fails here. Then, from
    a 2-layer full-width ``abstract_params`` on the meta device with each
    weight's kept blocks at 0.75 sparsity padded to the plan's chunk:
    attention 8.46e9 B in bf16, MLPs 7.36e9 B, the bf16 embedding and head
    2.28e9 B: 18.10e9 B in all, against 79.45e9 B for its fp32
    ``init_params`` tree; one layer's fp32 draw (what the layer-at-a-time
    build holds beside the tree) is 1.56e9 B."""
    small = get_config("internvl2-26b-reduced")
    assert small.num_layers == 2
    built, stats = psparse.build_sparse_params(small, 5, 0.75,
                                               device="cpu")
    padded = {n: w["padded"][0] for n, w in stats["weights"].items()}
    meta = ptfm.abstract_params(small)
    reckoned = _served_bytes(list(_leaves(meta["blocks"])), 2,
                             lambda name, nb: padded[name]) * 2 \
        + _served_bytes([kv for kv in _leaves(meta)
                         if not kv[0].startswith("blocks/")], 1, None)
    assert reckoned == _nbytes(built)

    cfg = get_config("internvl2-26b")
    chunk = pplan.bcsc_chunk()
    kept = lambda name, nb: -(-round(nb * 0.25) // chunk) * chunk
    two = ptfm.abstract_params(dataclasses.replace(cfg, num_layers=2))
    blocks = list(_leaves(two["blocks"]))
    attn = _served_bytes([kv for kv in blocks if "/attn/" in kv[0]], 2,
                         kept)
    mlp = _served_bytes([kv for kv in blocks if "/mlp/" in kv[0]], 2, kept)
    layer = _served_bytes(blocks, 2, kept)
    head = _served_bytes([kv for kv in _leaves(two) if
                          not kv[0].startswith("blocks/")], 1, kept)
    total = cfg.num_layers * layer + head
    assert 48 * attn == pytest.approx(8.456e9, rel=1e-3)
    assert 48 * mlp == pytest.approx(7.362e9, rel=1e-3)
    assert head == pytest.approx(2.278e9, rel=1e-3)
    assert total == pytest.approx(18.10e9, rel=1e-3)
    assert cfg.param_count() * 4 == pytest.approx(79.45e9, rel=1e-3)
    one = sum(t.numel() for _, t in blocks) // 2 * 4
    assert one == pytest.approx(1.560e9, rel=1e-3)
    assert total + 2 * one < 24 * 2**30
