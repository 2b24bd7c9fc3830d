"""Architecture config registry of the port: the dense decoders it serves
(``qwen2.5-3b``, ``gemma2-2b``, ``mistral-nemo-12b`` and ``gemma3-12b``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma2-2b": "gemma2_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma3-12b": "gemma3_12b",
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


__all__ = ["ArchConfig", "ARCH_NAMES", "get_config"]
