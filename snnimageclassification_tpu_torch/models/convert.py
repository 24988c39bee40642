"""Carry parameters across from the JAX package.

Both packages keep params as ``{layer: {leaf: array}}`` with ``w_in`` in
``(in, out)`` order, so a conversion is a plain copy.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device="cuda") -> dict:
    """``{layer: {leaf: np.ndarray}}`` (e.g. ``jax.device_get(params)``)
    -> the port's ``{layer: {leaf: tensor}}`` on ``device``, dtypes kept
    (bfloat16 arrays, as ml_dtypes stores them, become torch.bfloat16)."""
    dev = resolve_device(device)
    out = {}
    for name, group in params_np.items():
        out[name] = {}
        for leaf, arr in group.items():
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(
                    np.ascontiguousarray(arr).view(np.int16).copy()
                ).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
            out[name][leaf] = t.to(dev)
    return out
