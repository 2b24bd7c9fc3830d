"""The port's shard-explicit collectives, specs and int8 gradient
compression against the reference's on the CPU.

The reference's collectives run under ``shard_map`` on eight host devices,
in one subprocess for this file (the device count must be set before JAX
starts, as in ``tests/test_collectives.py``); a module-scoped fixture loads
its results from an npz. The port holds every device's value on a leading
stacked axis. Tolerances: ``hierarchical_psum`` and ``allreduce_stacked``
within 1e-6 (as the reference holds itself against a flat psum: fp32 sums
in another order); the ring all-gather exact (values are moved, never
added); ``quantize`` and ``compressed_allreduce_leaf`` bit for bit given
the same gradients and residuals.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.sharding import specs as rspecs
from repro.train import grad_compression as rgc

from repro_torch.sharding import collectives, specs
from repro_torch.sharding.mesh import TrainMesh, make_local_mesh, mesh_desc
from repro_torch.sharding.specs import P
from repro_torch.train import grad_compression as gc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 3, 5), (8, 7), (8, 2, 3, 4))   # stacked: 8 devices first

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.sharding import collectives
from repro.train import grad_compression

try:
    from jax.sharding import AxisType
    kw = lambda n: {"axis_types": (AxisType.Auto,) * n}
except ImportError:
    kw = lambda n: {}
d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "in.npz")))
out = {}
pod = jax.make_mesh((2, 4), ("pod", "data"), **kw(2))
flat = jax.make_mesh((8,), ("data",), **kw(1))
ring = jax.make_mesh((8,), ("model",), **kw(1))
for i in range(3):
    x = jnp.asarray(inp[f"x{i}"])
    out[f"hier{i}"] = np.asarray(collectives.shard_map(
        lambda v: collectives.hierarchical_psum(v[0], "pod", "data"),
        mesh=pod, in_specs=P(("pod", "data")), out_specs=P())(x))
    out[f"stacked_pod{i}"] = np.asarray(collectives.allreduce_stacked(pod, x))
    out[f"stacked{i}"] = np.asarray(collectives.allreduce_stacked(flat, x))
    out[f"ring{i}"] = np.asarray(collectives.shard_map(
        lambda v: collectives.ring_allgather(v, "model"),
        mesh=ring, in_specs=P("model"), out_specs=P("model"))(x))
for name, mesh, axes in (("dp4", jax.make_mesh(
        (4,), ("data",), devices=jax.devices()[:4], **kw(1)), ("data",)),
                         ("pod", pod, ("pod", "data"))):
    g, e = jnp.asarray(inp[f"g_{name}"]), jnp.asarray(inp[f"e_{name}"])

    def body(gl, el):
        s, ne = grad_compression.compressed_allreduce_leaf(gl[0], el[0], axes)
        return s[None], ne[None]
    total, new = collectives.shard_map(
        body, mesh=mesh, in_specs=(P(axes), P(axes)),
        out_specs=(P(axes), P(axes)))(g, e)
    out[f"total_{name}"] = np.asarray(total)
    out[f"ef_{name}"] = np.asarray(new)
np.savez(os.path.join(d, "out.npz"), **out)
print("REF_OK")
"""


def _grads(rng, n, shape):
    g = rng.standard_normal((n,) + shape).astype(np.float32)
    g[:, 0] *= 40.0                        # one large entry per replica
    return g, (0.01 * rng.standard_normal((n,) + shape)).astype(np.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    inp = {f"x{i}": rng.standard_normal(s).astype(np.float32)
           for i, s in enumerate(SHAPES)}
    inp["g_dp4"], inp["e_dp4"] = _grads(rng, 4, (33, 17))
    inp["g_pod"], inp["e_pod"] = _grads(rng, 8, (5, 64))
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(d)], env=env,
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_hierarchical_psum_matches_reference(ref, i):
    """RS(data) -> AR(pod) -> AG(data) on a pod=2, data=4 mesh: every
    device's result within 1e-6 of the reference's (sizes that do and do
    not divide the inner axis: the padded path)."""
    inp, out = ref
    x = torch.from_numpy(inp[f"x{i}"])
    got = collectives.hierarchical_psum(x.reshape((2, 4) + x.shape[1:]))
    assert got.shape == (2, 4) + x.shape[1:]
    for p in range(2):
        for j in range(4):
            np.testing.assert_allclose(got[p, j].numpy(), out[f"hier{i}"],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_allreduce_stacked_matches_reference(ref, i):
    """The stacked sum on a pod mesh (the hierarchical schedule) and on a
    flat data=8 one, within 1e-6 of the reference's."""
    inp, out = ref
    x = torch.from_numpy(inp[f"x{i}"])
    for mesh, key in ((TrainMesh(pod=2, data=4, device="cpu"), "stacked_pod"),
                      (TrainMesh(data=8, device="cpu"), "stacked")):
        np.testing.assert_allclose(
            collectives.allreduce_stacked(mesh, x).numpy(), out[f"{key}{i}"],
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_ring_allgather_matches_reference(ref, i):
    """The ring all-gather over a model=8 axis equals the reference's
    exactly, each device's values in source-index order."""
    inp, out = ref
    x = torch.from_numpy(inp[f"x{i}"])
    local = x.reshape((8, 1) + x.shape[1:])             # a slice a device
    got = collectives.ring_allgather(local)             # (8, 8, 1, ...)
    want = out[f"ring{i}"]                  # devices' results, concatenated
    assert np.array_equal(got.reshape(want.shape).numpy(), want)
    for dev in range(8):
        assert torch.equal(got[dev], local)


@pytest.mark.parametrize("name,n", [("dp4", 4), ("pod", 8)])
def test_compressed_allreduce_leaf_bit_for_bit(ref, name, n):
    """Given the same gradients and residuals, the summed gradient and
    every replica's new residual equal the reference's bit for bit (on a
    data=4 mesh, and over (pod, data) on pod=2, data=4, whose gather
    stacks the payloads data-major: ``gather_order``)."""
    inp, out = ref
    mesh = TrainMesh(data=4, device="cpu") if n == 4 else \
        TrainMesh(pod=2, data=4, device="cpu")
    total, new = gc.compressed_allreduce_leaf(
        torch.from_numpy(inp[f"g_{name}"]), torch.from_numpy(inp[f"e_{name}"]),
        mesh)
    for r in range(n):      # every replica holds the same sum
        assert np.array_equal(out[f"total_{name}"][r], total.numpy())
    assert np.array_equal(out[f"ef_{name}"], new.numpy())


def test_quantize_matches_reference_bit_for_bit():
    """``quantize`` / ``dequantize`` against the reference's: the int8
    payload, the scale and the residual bit for bit, half-way values
    rounded to even, all-zero and tiny gradients included."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    g[0, :4] = [63.5, -63.5, 0.5 * 127 / 63.5, 127.0]
    for grad in (g, np.zeros((5,), np.float32),
                 np.full((3, 2), 1e-30, np.float32)):
        ef = (0.1 * rng.standard_normal(grad.shape)).astype(np.float32)
        q, s, ne = gc.quantize(torch.from_numpy(grad), torch.from_numpy(ef))
        rq, rs, rne = rgc.quantize(jnp.asarray(grad), jnp.asarray(ef))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(s.numpy(), np.asarray(rs))
        assert np.array_equal(ne.numpy(), np.asarray(rne))
        assert np.array_equal(gc.dequantize(q, s).numpy(),
                              np.asarray(rgc.dequantize(rq, rs)))


def test_error_feedback_tracks_the_true_sum():
    """Over steps, the dequantized sums plus the residuals equal the true
    sums (error feedback loses nothing), and the payload is one byte an
    element plus a scale a leaf per replica."""
    rng = np.random.default_rng(4)
    mesh = TrainMesh(data=4, device="cpu")
    params = {"w": torch.zeros(6, 5), "b": torch.zeros(5)}
    ef = gc.init_error_feedback(mesh, params)
    assert ef["w"].shape == (4, 6, 5) and ef["b"].dtype == torch.float32
    sent = torch.zeros(4, 6, 5)
    true = torch.zeros(4, 6, 5)
    e = ef["w"]
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(
            np.float32))
        true += g
        total, e_new = gc.compressed_allreduce_leaf(g, e)
        step_sent = (g + e) - e_new      # what each replica sent
        torch.testing.assert_close(total, step_sent.sum(0), rtol=0,
                                   atol=1e-5)
        sent += step_sent
        e = e_new
    torch.testing.assert_close(sent + e, true, rtol=0, atol=1e-5)
    assert gc.payload_bytes(params, 4) == 4 * (30 + 4 + 5 + 4)


# ------------------------------------------------------------------ specs
MESH_AXES_MP = {"pod": 2, "data": 16, "model": 16}


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 8192),
       st.sampled_from([None, "model", ("data",), ("pod", "data"),
                        ("pod", "data", "model")]))
def test_maybe_and_axes_size_match_reference(dim, axes):
    assert specs.maybe(axes, dim, MESH_AXES_MP) == \
        rspecs.maybe(axes, dim, MESH_AXES_MP)
    assert specs.axes_size(MESH_AXES_MP, axes) == \
        rspecs.axes_size(MESH_AXES_MP, axes)


def test_mesh_axes_and_local_mesh():
    """``TrainMesh``'s axes as the reference names them, ``dp_axes``,
    ``make_local_mesh`` over the one CPU (data=1, model=1) and
    ``mesh_desc``; a mesh larger than the devices is logical."""
    m = TrainMesh(data=2, model=4, device="cpu")
    assert specs.mesh_axis_sizes(m) == {"data": 2, "model": 4}
    assert specs.dp_axes(specs.mesh_axis_sizes(m)) == ("data",)
    mp = TrainMesh(pod=2, data=2, model=2, device="cpu")
    assert mp.axis_names == ("pod", "data", "model") and mp.dp == 4
    assert specs.dp_axes(specs.mesh_axis_sizes(mp)) == \
        rspecs.dp_axes(MESH_AXES_MP)
    local = make_local_mesh(device="cpu")
    assert (local.data, local.model, local.size, local.backed) == \
        (1, 1, 1, True)
    assert not m.backed
    d = mesh_desc(mp)
    assert (d.pod, d.data, d.model, d.chips) == (2, 2, 2, 8)
    with pytest.raises(ValueError):
        make_local_mesh(model=2, device="cpu")


def test_layout_shards_partition_exactly():
    """The shards of a layout, over every device's coordinates, cover the
    tensor once (views; the first axis of an entry outermost); a spec
    that does not divide, or names an axis twice, is refused."""
    mesh = TrainMesh(data=2, model=4, device="cpu")
    x = torch.arange(16 * 12).reshape(16, 12)
    for spec in (P(("data", "model"), None), P("model", "data"),
                 P(None, "model"), P()):
        layout = specs.named(mesh, spec)
        cover = torch.zeros(16, 12)
        for c in layout.coords():
            part = layout.shard(cover, c)
            assert part.shape == layout.local_shape(cover.shape)
            part.add_(1)                 # a view: marks its elements
        n = int(np.prod(layout.parts(cover.shape)))
        assert torch.equal(cover, torch.full_like(cover, 8 // n))
    assert specs.named(mesh, P(("data", "model"))).shard(
        x, {"data": 1, "model": 2})[0, 0] == 6 * 2 * 12
    for bad in (P(None, None, None), P("data", "data"), P("pod"),
                P(None, ("data", "model", "data"))):
        with pytest.raises(ValueError):
            specs.named(mesh, bad).check(x.shape)
    with pytest.raises(ValueError, match="does not divide"):
        specs.named(TrainMesh(data=3, device="cpu"), P("data")).check((16,))
    tree = specs.tree_named(mesh, {"a": P("data"), "b": (P(), P("model"))})
    assert tree["b"][1].spec == P("model") and tree["a"].mesh is mesh


def test_collectives_on_one_device_are_identities():
    """On a one-device mesh the collectives return their input, as the
    reference's do on its one-device mesh."""
    x = torch.arange(8.0)[None]
    assert torch.equal(collectives.allreduce_stacked(
        TrainMesh(device="cpu"), x), x[0])
    assert torch.equal(collectives.hierarchical_psum(x[None]), x[None])
    assert torch.equal(collectives.ring_allgather(x), x[None])
