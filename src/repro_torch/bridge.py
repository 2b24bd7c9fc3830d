"""Load the reference package's parameter trees into the port.

The reference keeps parameters as a nested dict of arrays; handed over as
numpy (``jax.tree.map(np.asarray, params)``), the same tree becomes the
port's params here, key for key: stacked layers stay on their leading layer
axis and BCSC packs keep their keys (``blocks``, ``row_ids``, ``col_ids``,
``nnzb``, and ``_bcsc_counts`` beside them). Only the container type
changes, from numpy array to tensor; dtypes are kept, bfloat16 included.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor of the same dtype. numpy has no
    bfloat16 of its own; arrays of the ``ml_dtypes`` bfloat16 that JAX hands
    out are carried bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The reference's parameter tree (numpy leaves) as the port's."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
