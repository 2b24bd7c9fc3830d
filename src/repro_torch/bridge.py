"""Carry the reference package's parameter trees and train states into
the port, and back.

The reference keeps parameters as a nested dict of arrays; handed over as
numpy (``jax.tree.map(np.asarray, params)``), the same tree becomes the
port's params here, key for key: stacked layers stay on their leading layer
axis and BCSC packs keep their keys (``blocks``, ``row_ids``, ``col_ids``,
``nnzb``, and ``_bcsc_counts`` beside them). Only the container type
changes, from numpy array to tensor; dtypes are kept, bfloat16 included.
A train state, (params, ``AdamWState(step, mu, nu)``), crosses the same
way in both directions (``train_state_from_numpy``,
``train_state_to_numpy``).
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


def tensor_to_numpy(t) -> np.ndarray:
    """A tensor as a numpy array of the same dtype (bfloat16 as the
    ``ml_dtypes`` bfloat16 JAX takes, when that package is present)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree: Dict) -> Dict:
    """The port's parameter tree with numpy leaves (the reference's)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def train_state_from_numpy(state, device=None):
    """(params, opt state) with numpy leaves, the opt state anything with
    ``step``, ``mu`` and ``nu`` (the reference's ``AdamWState``) or a
    (step, mu, nu) tuple -> (params, ``train.optimizer.AdamWState``) of
    tensors on ``device``."""
    from repro_torch.train.optimizer import AdamWState
    params, opt = state
    step, mu, nu = (opt.step, opt.mu, opt.nu) if hasattr(opt, "mu") \
        else opt
    return (params_from_numpy(params, device),
            AdamWState(step=tensor_from_numpy(step, device),
                       mu=params_from_numpy(mu, device),
                       nu=params_from_numpy(nu, device)))


def train_state_to_numpy(state):
    """(params, AdamWState) of tensors -> (params, (step, mu, nu)) of
    numpy arrays, in the reference's layout (its ``AdamWState`` takes the
    three fields in that order)."""
    params, opt = state
    return (params_to_numpy(params),
            (tensor_to_numpy(opt.step), params_to_numpy(opt.mu),
             params_to_numpy(opt.nu)))
