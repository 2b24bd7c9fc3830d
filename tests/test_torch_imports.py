"""The port stands alone: no JAX and nothing of the reference package.

Every file of ``src/repro_torch``, ``chip_smoke.py`` and the port's scripts
is parsed, and any import of ``jax`` (or ``jaxlib``) or of
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
                ROOT / "scripts" / "ablate_kernels_torch.py"]
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
                 "runtime/fault_tolerance.py",
                 "kernels/ops.py", "kernels/_build.py", "models/decoding.py"):
        assert need in names


@pytest.mark.parametrize("module", ["repro_torch.serve.graphs",
                                    "repro_torch.serve.guard",
                                    "repro_torch.serve.engine",
                                    "repro_torch.serve.chaos",
                                    "repro_torch.serve.telemetry",
                                    "repro_torch.runtime.fault_tolerance"])
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
