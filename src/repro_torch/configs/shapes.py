"""The input shapes of the dry-run's cells (the port's copy of
``repro.configs.shapes``): four LM-transformer shapes, 40 cells with the
ten architectures.

``decode_*`` / ``long_*`` run ``serve_step`` (one new token against a KV
cache of ``seq_len``), ``train_4k`` runs ``train_step`` and
``prefill_32k`` runs ``prefill`` (``launch.cell``). ``long_500k`` is
runnable only for the architectures whose decode state is not a full
attention cache over the whole context.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}

# architectures of pure full attention: their long_500k cell is skipped
LONG_CONTEXT_SKIP = frozenset(
    {"mistral-nemo-12b", "qwen2.5-3b", "internvl2-26b", "musicgen-large"}
)


def cell_is_runnable(arch_name: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch_name in LONG_CONTEXT_SKIP:
        return False
    return True


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    """The shape shrunk for CPU tests (same kind)."""
    return ShapeConfig(shape.name + "-reduced", shape.kind,
                       seq_len=64, global_batch=2)
