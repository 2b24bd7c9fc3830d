"""Data-parallel training over processes (``sharding.dist``) on the CPU.

Each world runs once, in processes started by ``dist.spawn`` (gloo, a
``FileStore`` in a fresh temporary directory, one thread a rank, as the
test process runs), whose rank programs below return what each rank
holds. The one-process steps they are held to run in this process, from
the same seeded weights (``init_params``, seed 0) and the same numpy
batch. The reference's jitted ``launch.train`` path runs in one
subprocess on two forced host devices (``XLA_FLAGS`` must be set before
JAX starts), compiled with XLA's excess precision off as in
``tests/test_torch_mesh_train.py``. Tolerances, and why:

* the collectives at world 4 as pod 2 x data 2 against the stacked
  ``hierarchical_psum``, ``allreduce_stacked`` and ``ring_allgather``:
  bit for bit (every sum has two operands, so no order can change it);
* compressed DP at world 4 against ``make_compressed_dp_train_step`` on
  ``TrainMesh(data=4)``: params, moments, each rank's residual slot and
  the loss bit for bit (the same quantization, the same ``_combine`` in
  the same order);
* plain DP at world 2 against this file's own row-split sum: bit for bit
  (a sum of two); at world 4 within ``SUM_TOL`` (1e-6) of each leaf's max
  |value| (gloo's all-reduce adds four gradients in its own order); both
  against the whole-batch step and the reference's at ``LOSS_TOL`` (1e-4)
  relative and ``GRAD_TOL`` (2e-2) of each first-moment leaf's max (the
  rows' means summed in another order, bf16 roundings of the model);
* ``launch.train --nproc 2`` against one process: losses within 1e-4;
* checkpoints: equal values at every world.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.data import pipeline as pdata
from repro_torch.launch import train as plaunch
from repro_torch.models import transformer as ptfm
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Supervisor)
from repro_torch.sharding import collectives, dist
from repro_torch.sharding.mesh import TrainMesh, make_local_mesh
from repro_torch.train import grad_compression as gc
from repro_torch.train import loop as ploop
from repro_torch.train import optimizer as popt

LOSS_TOL = 1e-4
GRAD_TOL = 2e-2
SUM_TOL = 1e-6
ARCH = "qwen2.5-3b-reduced"
SEQ = 64                     # one row of 64 tokens a rank
SHAPE = planner.ShapeConfig("t", "train", SEQ, 4)
JOIN_S = 120.0               # no world here takes more than ~10 s
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_config
from repro.core import planner
from repro.launch import mesh as mesh_lib
from repro.launch.cell import mesh_desc
from repro.sharding import autoshard
from repro.train import loop, optimizer as opt_lib

d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "in.npz")))
out = {}

def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = t
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return t

def put(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(str(e.key) for e in path)] = np.asarray(leaf)

# launch.train's path: the local mesh over the (two) devices, its plan
# and hints, make_train_step, jax.jit with the state donated
cfg = get_config("qwen2.5-3b-reduced")
mesh = mesh_lib.make_local_mesh()
assert mesh.devices.size == 2, mesh
params, batch = tree("p/"), tree("b/")
B, S = batch["tokens"].shape
plan = planner.plan_model(cfg, ShapeConfig("cli", "train", S, B),
                          mesh_desc(mesh))
hints = autoshard.make_hints(plan, mesh, B)
opt_cfg = opt_lib.OptimizerConfig(peak_lr=3e-4, warmup_steps=0,
                                  total_steps=1)
step_fn = loop.make_train_step(cfg, opt_cfg, remat_policy="none",
                               microbatches=1, hints=hints)
jitted = jax.jit(step_fn, donate_argnums=(0, 1), compiler_options={
    "xla_allow_excess_precision": False})
p1, o1, m = jitted(params, opt_lib.init_adamw(params), batch)
put("metrics/", m)
put("mu/", o1.mu)
np.savez(os.path.join(d, "out.npz"), **out)
print("REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread here and in every rank (``dist.spawn`` divides this
    process's threads): the one-process steps and the ranks then take
    the same CPU code paths, which bit-for-bit equality needs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return get_config(ARCH)


def _init():
    params = ptfm.init_params(_cfg(), torch.Generator().manual_seed(0), "cpu")
    return params, popt.init_adamw(params)


def _batch(rows):
    return pdata.to_torch(pdata.batch_for_arch(_cfg(), SEQ, rows, 0))


def _opt():
    """``launch.train``'s optimizer for a one-step run."""
    return popt.OptimizerConfig(peak_lr=3e-4, warmup_steps=0, total_steps=1)


def _state(params, opt):
    return {"params": params, "mu": opt.mu, "nu": opt.nu, "step": opt.step}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if not torch.equal(fa[k], fb[k])]
    assert not bad, bad


def _checksums(params):
    return [int(dist._bits(p).sum(dtype=torch.int64))
            for p in popt.leaves(params)]


# ------------------------------------------------------------ rank programs
def _plain_rank(group, rows, ckpt_dir=None):
    """One plain DP step over ``rows`` rows; at world 2 the state is then
    checkpointed (rank 0 writes)."""
    mesh = make_local_mesh(group=group)
    params, opt = _init()
    step = ploop.make_train_step(_cfg(), _opt(), remat_policy="none",
                                 mesh=mesh)
    params, opt, m = step(params, opt, _batch(rows))
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir, group=group).save(0, (params, opt))
    return {"state": _state(params, opt),
            "metrics": {k: float(v) for k, v in m.items()}}


def _supervised(group, ckpt_dir, fail_at):
    """Three steps under the Supervisor, a checkpoint a step; rank 1's
    attempt 0 of step ``fail_at`` fails (None: no failure)."""
    mesh = make_local_mesh(group=group)
    step = ploop.make_train_step(_cfg(), _opt(), remat_policy="none",
                                 mesh=mesh)
    seen, last = [], {}

    def injector(s, attempt):
        if group.rank == 1 and s == fail_at and attempt == 0:
            raise RuntimeError("injected")

    def wrapped(state, batch):
        seen.append(int(state[1].step))
        params, opt, m = step(*state, batch)
        last["sums"] = _checksums(params)
        return (params, opt), m
    sup = Supervisor(FaultToleranceConfig(checkpoint_dir=ckpt_dir,
                                          checkpoint_every=1,
                                          backoff_s=0.0),
                     step_fn=wrapped, data_fn=lambda s: _batch(2),
                     init_state_fn=_init, failure_injector=injector,
                     group=group)
    result = sup.run(3)
    return {"restarts": result["restarts"], "seen": seen,
            "steps": CheckpointManager(ckpt_dir).steps(),
            "final": last["sums"]}


def _world2(group, d):
    out = _plain_rank(group, 2, os.path.join(d, "ckpt2"))
    out["retry"] = _supervised(group, os.path.join(d, "retry"), 1)
    out["clean"] = _supervised(group, os.path.join(d, "clean"), None)
    return out


def _collectives_rank(group):
    """A float value of 15 elements (padded to 16 over data=2) and an
    int8 one per rank, from one seeded generator; a strided (transposed)
    value of whole numbers, whose sum no order changes, over the flat
    world-4 mesh."""
    mesh = TrainMesh(pod=2, data=2, device="cpu", group=group)
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 5, 3)).astype(np.float32))
    qs = torch.from_numpy(np.random.default_rng(6).integers(
        -127, 128, (4, 7), dtype=np.int8))
    dp_mesh = make_local_mesh(group=group)
    strided = (torch.arange(12.0).reshape(3, 4) * (group.rank + 1)).t()
    return {"strided": collectives.allreduce_ranks(dp_mesh, strided),
            "hier": collectives.allreduce_ranks(mesh, xs[group.rank].clone()),
            "gather": collectives.allgather_ranks(mesh, xs[group.rank]),
            "gather_q": collectives.allgather_ranks(mesh, qs[group.rank]),
            "mean": collectives.mean_over_ranks(mesh, list(xs[group.rank,
                                                               0]))}


def _compressed_rank(group, steps):
    mesh = make_local_mesh(group=group)
    params, opt = _init()
    ef = gc.init_error_feedback(mesh, params)
    step = gc.make_compressed_dp_train_step(
        mesh, ploop.make_loss_fn(_cfg(), "none"), popt.OptimizerConfig())
    losses = []
    for _ in range(steps):
        params, opt, ef, m = step(params, opt, _batch(4), ef)
        losses.append(m["loss_total"])
    return {"state": _state(params, opt), "ef": ef, "losses": losses}


def _world4(group, d):
    mesh = make_local_mesh(group=group)
    state, manifest = elastic.restore_elastic(
        CheckpointManager(os.path.join(d, "ckpt2")),
        ploop.abstract_train_state(_cfg()), _cfg(), SHAPE, mesh)
    return {"collectives": _collectives_rank(group),
            "compressed": _compressed_rank(group, 2),
            "plain": _plain_rank(group, 4),
            "restored": _state(state[0], state[1]),
            "restored_step": manifest["step"]}


def _fails(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group)          # waits for a rank that never comes


def _sleeps(group):
    time.sleep(60)


def _raises_in_step(group, log_dir):
    """Two steps under the Supervisor: rank 1's step raises at step 0
    while rank 0's waits in the step's all-reduce. Each rank notes its
    state inits and its steps in a file of ``log_dir``."""
    mesh = make_local_mesh(group=group)
    path = os.path.join(log_dir, f"{group.rank}.log")

    def note(what):
        with open(path, "a") as f:
            f.write(what + "\n")

    def init():
        note("init")
        return torch.zeros(3)

    def step(state, batch):
        note("step")
        if group.rank == 1:
            raise ValueError("rank 1's step fails on purpose")
        return collectives.allreduce_ranks(mesh, state), {}
    Supervisor(FaultToleranceConfig(checkpoint_dir=os.path.join(log_dir,
                                                                "ckpt"),
                                    backoff_s=0.0),
               step_fn=step, data_fn=lambda s: None, init_state_fn=init,
               group=group).run(2)


# ---------------------------------------------------------------- worlds
@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference subprocess, started (it runs beside the worlds)."""
    d = tmp_path_factory.mktemp("dist_ref")
    params, _ = _init()
    inp = {f"p/{k}": v.numpy() for k, v in _flat(params).items()}
    inp.update({f"b/{k}": v for k, v in pdata.batch_for_arch(
        _cfg(), SEQ, 2, 0).items()})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world2(ref_run, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist2"))
    return dist.spawn(_world2, 2, d, device="cpu", join_timeout_s=JOIN_S), d


@pytest.fixture(scope="module")
def world4(world2):
    _, d = world2
    return dist.spawn(_world4, 4, d, device="cpu",
                      join_timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, d = ref_run
    out, err = proc.communicate(timeout=600)
    assert "REF_OK" in out, out + err[-4000:]
    return dict(np.load(d / "out.npz"))


def _row_split_step(n):
    """The plain DP step as this file computes it: each of n row blocks'
    gradients in one process, summed in order and divided by n, the loss
    and metrics averaged, then AdamW."""
    params, opt = _init()
    loss_fn = ploop.make_loss_fn(_cfg(), "none")
    parts = [ploop.value_and_grad(loss_fn, params, pdata.replica_rows(
        _batch(n), r, n)) for r in range(n)]
    grads = parts[0][2]
    for g_acc, *gs in zip(popt.leaves(grads),
                          *(popt.leaves(p[2]) for p in parts[1:])):
        for g in gs:
            g_acc.add_(g)
        g_acc.div_(n)
    params, opt, om = popt.adamw_update(_opt(), params, grads, opt)
    return _state(params, opt)


# ------------------------------------------------------------------ cases
def test_collectives_over_ranks_equal_the_stacked_ones(world4):
    """(a) World 4 as pod 2 x data 2: the hierarchical all-reduce (its
    zero padding included), the all-gather in source order and the mean
    over ranks equal the stacked collectives bit for bit on every rank;
    a strided value all-reduces in place over the flat mesh."""
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 5, 3)).astype(np.float32))
    qs = torch.from_numpy(np.random.default_rng(6).integers(
        -127, 128, (4, 7), dtype=np.int8))
    stacked = collectives.hierarchical_psum(xs.reshape(2, 2, 5, 3))
    whole = collectives.allreduce_stacked(
        TrainMesh(pod=2, data=2, device="cpu"), xs)
    ring = collectives.ring_allgather(xs)
    for r, out in enumerate(w["collectives"] for w in world4):
        assert torch.equal(out["strided"],
                           torch.arange(12.0).reshape(3, 4).t() * 10)
        assert torch.equal(out["hier"], stacked[r // 2, r % 2])
        assert torch.equal(out["hier"], whole)
        assert torch.equal(out["gather"], ring[r])
        assert torch.equal(out["gather_q"], qs)
        assert torch.equal(torch.stack(out["mean"]),
                           gc._pmean(list(xs[:, 0]), 4))


def test_compressed_dp_over_ranks_equals_one_process(world4):
    """(b) Compressed DP over 4 gloo ranks, 2 steps, equals the
    one-process step on ``TrainMesh(data=4)`` bit for bit: params,
    moments, the step, each rank's residual slot and each loss."""
    mesh = TrainMesh(data=4, device="cpu")
    params, opt = _init()
    ef = gc.init_error_feedback(mesh, params)
    step = gc.make_compressed_dp_train_step(
        mesh, ploop.make_loss_fn(_cfg(), "none"), popt.OptimizerConfig())
    losses = []
    for _ in range(2):
        params, opt, ef, m = step(params, opt, _batch(4), ef)
        losses.append(m["loss_total"])
    want = _state(params, opt)
    for r, out in enumerate(w["compressed"] for w in world4):
        _equal(out["state"], want)
        _equal(out["ef"], popt.map_tree(lambda e: e[r:r + 1], ef))
        assert [float(x) for x in out["losses"]] == [float(x) for x in losses]


def test_plain_dp_over_ranks_equals_the_row_split_sum(world2, world4):
    """(c) Plain DP: at world 2 equal to this file's row-split sum bit for
    bit, at world 4 within ``SUM_TOL`` of each leaf's max; at both worlds
    params equal on every rank, and the loss and first moments against
    the whole-batch step at ``LOSS_TOL`` / ``GRAD_TOL``."""
    ranks2, _ = world2
    for out in ranks2:
        _equal(out["state"], _row_split_step(2))
    want4 = _flat(_row_split_step(4))
    for out in world4:
        for k, v in _flat(out["plain"]["state"]).items():
            scale = max(float(want4[k].float().abs().max()), 1e-30)
            assert float((v - want4[k]).float().abs().max()) <= \
                SUM_TOL * scale, k
    for n, outs in ((2, [o for o in ranks2]), (4, [w["plain"]
                                                   for w in world4])):
        params, opt = _init()
        whole = ploop.make_train_step(_cfg(), _opt(), remat_policy="none")
        params, opt, m = whole(params, opt, _batch(n))
        for out in outs:
            _equal(out["state"]["params"], outs[0]["state"]["params"])
            np.testing.assert_allclose(out["metrics"]["loss"],
                                       float(m["loss"]), rtol=LOSS_TOL)
            for k, v in _flat(out["state"]["mu"]).items():
                w = _flat(opt.mu)[k]
                err = float((v - w).abs().max() / w.abs().max().clamp_min(
                    1e-30))
                assert err <= GRAD_TOL, (n, k, err)


def test_plain_dp_over_ranks_matches_the_references_launch_path(world2,
                                                                 ref):
    """(d) The world-2 step against the reference's jitted
    ``launch.train`` path on a forced 2-device host mesh (data=2,
    model=1) from the same weights and batch: loss, grad norm and
    accuracy at ``LOSS_TOL``, every first-moment leaf at ``GRAD_TOL`` of
    its max."""
    ranks2, _ = world2
    for out in ranks2:
        for k in ("loss", "loss_total", "grad_norm", "accuracy"):
            np.testing.assert_allclose(out["metrics"][k],
                                       ref[f"metrics/{k}"], rtol=LOSS_TOL,
                                       atol=1e-7)
        got = {k: v.numpy() for k, v in _flat(out["state"]["mu"]).items()}
        want = {k[len("mu/"):]: v for k, v in ref.items()
                if k.startswith("mu/")}
        assert got.keys() == want.keys()
        for k, w in want.items():
            err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= GRAD_TOL, (k, err)


def test_launch_train_spawns_ranks_on_the_cpu(tmp_path, capsys):
    """(e) ``launch.train --nproc 2 --device cpu``: two gloo ranks whose
    losses are within 1e-4 of one process's, rank 0 alone writing the
    one checkpoint of the run."""
    args = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt-dir"]
    one = plaunch.main(args + [str(tmp_path / "one")])
    two = plaunch.main(args + [str(tmp_path / "two"), "--nproc", "2"])
    assert "ranks=1" in capsys.readouterr().out
    a = [m["loss"] for m in one["metrics"]]
    b = [m["loss"] for m in two["metrics"]]
    np.testing.assert_allclose(b, a, rtol=1e-4)
    assert CheckpointManager(str(tmp_path / "two")).steps() == [1]
    assert two["restarts"] == 0


def test_checkpoint_restores_at_other_worlds(world2, world4):
    """(f) The world-2 checkpoint (rank 0 wrote it) restored elastically
    at world 1 here and at world 4 on every rank: equal values."""
    ranks2, d = world2
    saved = ranks2[0]["state"]
    state, manifest = elastic.restore_elastic(
        CheckpointManager(os.path.join(d, "ckpt2")),
        ploop.abstract_train_state(_cfg()), _cfg(), SHAPE,
        TrainMesh(device="cpu"))
    assert manifest["step"] == 0
    _equal(_state(state[0], state[1]), saved)
    for out in world4:
        assert out["restored_step"] == 0
        _equal(out["restored"], saved)


def test_supervisor_retry_is_collective(world2):
    """A failure injected on rank 1 alone: both ranks retry the step from
    the same checkpoint, and the run ends where the clean run ends."""
    ranks2, _ = world2
    for out in ranks2:
        assert out["retry"]["restarts"] == 1
        assert out["retry"]["seen"] == [0, 1, 2]
        assert out["retry"]["steps"] == out["clean"]["steps"] == [0, 1, 2]
        assert out["retry"]["final"] == out["clean"]["final"]
    assert ranks2[0]["retry"] == ranks2[1]["retry"]


def test_a_failing_rank_ends_the_job():
    """(g) A rank that raises ends the job with its error within the
    group timeout, its peer blocked in a collective stopped; ranks that
    outlive the join timeout are stopped too."""
    t0 = time.monotonic()
    # the first rank to exit is reported: rank 1, or rank 0 once gloo
    # finds its peer gone
    with pytest.raises(Exception, match="rank 1 fails on purpose|Process 0"):
        dist.spawn(_fails, 2, device="cpu", timeout_s=30,
                   join_timeout_s=JOIN_S)
    assert time.monotonic() - t0 < 30
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        dist.spawn(_sleeps, 2, device="cpu", join_timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_a_failure_inside_the_step_is_not_retried(tmp_path):
    """Under a group a step that raises on one rank ends the job with no
    retry (its peer waits in the step's all-reduce, which a retry's
    collectives would not match): the rank neither restores nor steps
    again, and the job ends within the group timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="step fails on purpose|Process 0"):
        dist.spawn(_raises_in_step, 2, str(tmp_path), device="cpu",
                   timeout_s=30, join_timeout_s=JOIN_S)
    assert time.monotonic() - t0 < 30
    assert (tmp_path / "1.log").read_text().split() == ["init", "step"]


def test_spawn_defaults_to_the_card(monkeypatch):
    """``dist.spawn`` with no device runs a rank a card: with no CUDA
    device it raises before it starts a rank, and never runs the ranks
    on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.spawn(_sleeps, 2, join_timeout_s=3)
    assert time.monotonic() - t0 < 3


def test_process_mesh_shape_and_refusals():
    """A process mesh's dp index is its rank and it is backed; one process
    backs only a mesh of one replica; a group whose world is not the dp
    size, or a model axis across ranks, is refused."""
    g = dist.Group(rank=1, world=2, local_rank=1, backend="gloo",
                   device=torch.device("cpu"))
    mesh = make_local_mesh(group=g)
    assert (mesh.data, mesh.dp_index, mesh.backed, mesh.device) == \
        (2, 1, True, "cpu")
    assert make_local_mesh(device="cpu").backed
    assert not TrainMesh(data=2, device="cpu").backed
    assert not TrainMesh(device="meta").backed
    with pytest.raises(ValueError):
        TrainMesh(data=4, device="cpu", group=g)
    with pytest.raises(ValueError):
        make_local_mesh(model=2, group=g)
    assert dist.default_backend("cuda:1") == "nccl"
    assert dist.default_backend("cpu") == "gloo"
    assert pdata.replica_rows({"t": np.arange(8)}, 3, 4)["t"].tolist() == \
        [6, 7]
    with pytest.raises(ValueError):
        pdata.replica_rows({"t": np.arange(6)}, 0, 4)
