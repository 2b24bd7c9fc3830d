"""Architecture config registry of the port: the architectures it serves
(the dense decoders ``qwen2.5-3b``, ``gemma2-2b``, ``mistral-nemo-12b`` and
``gemma3-12b``; the recurrent ``recurrentgemma-2b`` and ``mamba2-130m``;
the mixture-of-experts ``mixtral-8x7b`` and ``llama4-maverick-400b-a17b``;
the frontend architectures ``internvl2-26b``, vision patches prepended to
the text, and ``musicgen-large``, four codebooks, sinusoidal positions and
cross-attention to a conditioning sequence)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, train_flops_per_token
from repro_torch.configs.shapes import (LONG_CONTEXT_SKIP, SHAPES,
                                        ShapeConfig, cell_is_runnable,
                                        reduced_shape)

_ARCH_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma2-2b": "gemma2_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma3-12b": "gemma3_12b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-130m": "mamba2_130m",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "internvl2-26b": "internvl2_26b",
    "musicgen-large": "musicgen_large",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    """``name`` or ``name-reduced`` for every ported architecture."""
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_cells():
    """Every (arch, shape, runnable) cell: 40, in ``ARCH_NAMES`` order (not
    the reference's order; the same set)."""
    for a in ARCH_NAMES:
        for s in SHAPES.values():
            yield a, s, cell_is_runnable(a, s.name)


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ARCH_NAMES", "LONG_CONTEXT_SKIP",
    "get_config", "all_cells", "cell_is_runnable", "reduced_shape",
    "train_flops_per_token",
]
