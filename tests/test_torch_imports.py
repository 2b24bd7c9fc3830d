"""The port stands alone: no JAX and nothing of the reference package.

Every file of ``src/repro_torch``, ``chip_smoke.py`` and the port's scripts
and examples is parsed, and any import of ``jax`` (or ``jaxlib``) or of
``repro``/``repro.*`` fails the test.
"""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import plan_for_scheduler
from repro_torch.serve import LLM

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FILES = PORT + [ROOT / "chip_smoke.py",
                ROOT / "scripts" / "profile_decode_torch.py",
                ROOT / "scripts" / "ablate_kernels_torch.py",
                ROOT / "scripts" / "profile_train_torch.py",
                ROOT / "examples" / "torch_serve_lm.py",
                ROOT / "examples" / "torch_sparse_inference.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT}
    for need in ("bridge.py", "serve/facade.py", "serve/scheduler.py",
                 "serve/engine.py", "serve/graphs.py", "serve/guard.py",
                 "serve/chaos.py", "serve/telemetry.py",
                 "serve/router.py", "serve/replica.py",
                 "runtime/fault_tolerance.py", "core/eyexam.py",
                 "core/reuse.py",
                 "kernels/ops.py", "kernels/_build.py", "models/decoding.py",
                 "models/rglru.py", "models/ssm.py", "models/moe.py",
                 "models/frontend.py", "configs/musicgen_large.py",
                 "configs/internvl2_26b.py", "models/flash.py",
                 "kernels/flash_backward.py", "train/optimizer.py",
                 "train/loop.py", "data/pipeline.py",
                 "checkpoint/manager.py", "launch/train.py",
                 "launch/serve.py", "serve/shard.py", "core/hmmesh.py",
                 "core/planner.py", "sharding/tensor_parallel.py",
                 "configs/shapes.py", "launch/mesh.py", "launch/cell.py",
                 "launch/dryrun.py", "sharding/dist.py"):
        assert need in names


@pytest.mark.parametrize("module", ["repro_torch.serve.graphs",
                                    "repro_torch.serve.guard",
                                    "repro_torch.serve.engine",
                                    "repro_torch.serve.chaos",
                                    "repro_torch.serve.telemetry",
                                    "repro_torch.serve.router",
                                    "repro_torch.serve.replica",
                                    "repro_torch.runtime.fault_tolerance",
                                    "repro_torch.models.flash",
                                    "repro_torch.kernels.flash_backward",
                                    "repro_torch.train.loop",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.checkpoint.manager",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.serve",
                                    "repro_torch.serve.shard",
                                    "repro_torch.sharding.tensor_parallel",
                                    "repro_torch.core.planner",
                                    "repro_torch.configs.shapes",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.cell",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.sharding.dist"])
def test_decode_loop_modules_import_without_a_card(module):
    """The graph, guard, chaos and telemetry modules import on a machine
    without CUDA: a graph is captured only when a decode loop first runs
    on the card."""
    import importlib
    assert importlib.import_module(module)


def test_llm_defaults_to_the_card(monkeypatch):
    """Without ``device`` the port asks for CUDA and refuses to fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b-reduced")
    plan = plan_for_scheduler(cfg, rows=1, cache_len=32, share_prefix=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM(cfg, {}, plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM(cfg, {}, plan, device="cuda")


def test_train_launch_defaults_to_the_card(monkeypatch):
    """The training CLI resolves its device as ``LLM`` does: the card
    unless ``--device cpu`` is given, raising without one."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "1"])


def test_serve_launch_defaults_to_the_card(monkeypatch):
    """The serving CLI resolves its device as ``LLM`` does: the card
    unless ``--device cpu`` is given, raising without one."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2.5-3b", "--reduced", "--requests", "1"])
    assert serve.parse_args(["--arch", "qwen2.5-3b"]).device == "cuda"


def test_scheduler_defaults_to_the_card(monkeypatch):
    """The scheduler, an entry point too, resolves its device as ``LLM``
    does: the card by default, raising without one."""
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b-reduced")
    plan = plan_for_scheduler(cfg, rows=1, cache_len=32, share_prefix=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingScheduler(cfg, {}, plan)
    sch = ContinuousBatchingScheduler(cfg, {}, plan, device="cpu")
    assert sch.device.type == "cpu"


def test_meta_tensors_take_the_plain_version():
    """``kernels.ops`` sends a ``meta`` tensor (a cell's step run for its
    shapes and FLOPs) to the plain version, a CPU tensor too, and still
    refuses every other device that is not CUDA: there is no other
    fallback."""
    from repro_torch.kernels import ops
    assert ops._use_kernel(torch.empty(2, device="meta"), None) is False
    assert ops._use_kernel(torch.empty(2), None) is False
    assert ops._use_kernel(_OnDevice("cuda"), None) is True
    for kind in ("xpu", "mps"):
        with pytest.raises(RuntimeError, match="no kernel for tensors on"):
            ops._use_kernel(_OnDevice(kind), None)


class _OnDevice:
    """A stand-in tensor on a device that is neither the CPU, ``meta`` nor
    CUDA (no such backend is needed to ask where it lives)."""

    def __init__(self, kind):
        self.device = torch.device(kind)
