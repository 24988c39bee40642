"""Carry parameters and Adam state across to and from the JAX package.

Both packages keep params as ``{layer: {leaf: array}}`` with ``w_in`` in
``(in, out)`` order, so a conversion is a plain copy; an ensemble's stacked
params (a leading replica axis on every leaf) cross the same way.  Everything crosses
as numpy: this module imports neither package's framework but torch.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "adam_state_from_optax",
           "adam_state_to_numpy"]


def params_from_jax(params_np: Mapping[str, Mapping[str, np.ndarray]],
                    device="cuda") -> dict:
    """``{layer: {leaf: np.ndarray}}`` (e.g. ``jax.device_get(params)``)
    -> the port's ``{layer: {leaf: tensor}}`` on ``device``, dtypes kept
    (bfloat16 arrays, as ml_dtypes stores them, become torch.bfloat16)."""
    dev = resolve_device(device)
    return {name: {leaf: _tensor(arr).to(dev) for leaf, arr in group.items()}
            for name, group in params_np.items()}


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_numpy(params) -> dict:
    """The way back: ``{layer: {leaf: tensor}}`` -> ``{layer: {leaf:
    np.ndarray}}`` on the host (bfloat16 leaves come back as float32,
    which holds them exactly)."""
    return {name: {leaf: _numpy(t) for leaf, t in group.items()}
            for name, group in params.items()}


def adam_state_from_optax(optimizer, count, mu, nu) -> None:
    """Start ``optimizer`` (a ``train.MaskedAdam``) from an optax Adam
    state: the step ``count`` and the moment trees ``mu`` and ``nu`` as
    ``{layer: {leaf: np.ndarray}}`` (``ScaleByAdamState`` fetched to the
    host).  Only the ``"weight"`` leaves are read; optax keeps no moments
    for masked ones.

    A vmapped state (``jax.vmap(tx.init)`` over an ensemble's stacked
    params) has ``count`` of shape ``(S,)`` and moments with a leading S;
    the replicas step together, so the counts are equal and one
    ``torch.optim.Adam`` over the stacked leaves holds them."""
    counts = np.asarray(count).reshape(-1)
    if counts.size == 0 or (counts != counts[0]).any():
        raise ValueError(f"replica step counts differ: {counts.tolist()}")
    count = int(counts[0])
    for (name, leaf), p in zip(optimizer.keys, optimizer.tensors):
        optimizer.adam.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": _tensor(mu[name][leaf]).to(p.device, p.dtype),
            "exp_avg_sq": _tensor(nu[name][leaf]).to(p.device, p.dtype),
        }


def adam_state_to_numpy(optimizer) -> dict:
    """``{"count": int, "mu": tree, "nu": tree}`` of a ``MaskedAdam``,
    trees over its ``"weight"`` leaves; zeros and count 0 before the first
    step."""
    out = {"count": 0, "mu": {}, "nu": {}}
    for (name, leaf), p in zip(optimizer.keys, optimizer.tensors):
        st = optimizer.adam.state.get(p)
        if st:
            out["count"] = int(st["step"])
            mu, nu = _numpy(st["exp_avg"]), _numpy(st["exp_avg_sq"])
        else:
            mu = nu = np.zeros(tuple(p.shape), np.float32)
        out["mu"].setdefault(name, {})[leaf] = mu
        out["nu"].setdefault(name, {})[leaf] = nu
    return out
