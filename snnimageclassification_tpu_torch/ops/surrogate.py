"""Surrogate-gradient spike functions as :class:`torch.autograd.Function`s.

Port of the JAX package's ops/surrogate.py (reference
``src/modules/spike_funcs.py``).  Forward: ``1.0`` where
``v >= threshold`` else ``0.0``.  Backward: the fast-sigmoid surrogate
``g / (gamma |v - thr| + 1)^2`` or the triangular "Phi" surrogate
``g gamma/(thr+eps) max(0, 1 - |v-thr|/(thr+eps))``.  Threshold and gamma
get zero cotangents (spike_funcs.py:62,79): ALIF's ``beta`` enters only
through the threshold, so a learnable beta never trains (quirk Q3).
"""
from __future__ import annotations

import enum
from typing import Callable

import torch

__all__ = [
    "SpikeFuncType",
    "surrogate_grad",
    "surrogate_grad_from_delta",
    "heaviside_sigmoid",
    "heaviside_phi",
    "PHI_EPSILON",
    "SPIKE_FN_REGISTRY",
    "resolve_spike_fn",
]

PHI_EPSILON = 1e-5  # HeavisidePhiApprox.epsilon (spike_funcs.py:66)


class SpikeFuncType(enum.Enum):
    """Mirror of the reference's SpikeFuncType enum (spike_funcs.py:7-9)."""

    FastSigmoid = enum.auto()
    Phi = enum.auto()


def surrogate_grad(spike_func: SpikeFuncType, v, threshold, gamma):
    """Closed-form surrogate derivative d spike / d v."""
    if spike_func == SpikeFuncType.FastSigmoid:
        denom = gamma * torch.abs(v - threshold) + 1.0
        return 1.0 / (denom * denom)
    if spike_func == SpikeFuncType.Phi:
        scale = gamma / (threshold + PHI_EPSILON)
        return scale * torch.clamp(
            1.0 - torch.abs((v - threshold) / (threshold + PHI_EPSILON)),
            min=0.0,
        )
    raise ValueError(f"No closed-form surrogate gradient for {spike_func}")


def surrogate_grad_from_delta(spike_func: SpikeFuncType, delta, threshold,
                              gamma):
    """:func:`surrogate_grad` as a function of ``delta = v - threshold``
    (Phi still needs the threshold for its scale)."""
    if spike_func == SpikeFuncType.FastSigmoid:
        denom = gamma * torch.abs(delta) + 1.0
        return 1.0 / (denom * denom)
    if spike_func == SpikeFuncType.Phi:
        scale = gamma / (threshold + PHI_EPSILON)
        return scale * torch.clamp(
            1.0 - torch.abs(delta / (threshold + PHI_EPSILON)), min=0.0
        )
    raise ValueError(f"No closed-form surrogate gradient for {spike_func}")


def _zero_cotangent(x, like: torch.Tensor):
    """Zero gradient for a tensor argument; None for a Python number."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x, dtype=like.dtype)
    return None


class _Heaviside(torch.autograd.Function):
    """Heaviside forward; the backward is the named closed-form surrogate."""

    @staticmethod
    def forward(ctx, v, threshold, gamma, spike_func):
        # Tensor arguments go through save_for_backward, numbers on ctx.
        args = (threshold, gamma)
        ctx.numbers = [None if isinstance(x, torch.Tensor) else x
                       for x in args]
        ctx.spike_func = spike_func
        ctx.save_for_backward(
            v, *(x for x in args if isinstance(x, torch.Tensor)))
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        v, *tensors = ctx.saved_tensors
        it = iter(tensors)
        threshold, gamma = (next(it) if x is None else x for x in ctx.numbers)
        dv = g * surrogate_grad(ctx.spike_func, v, threshold, gamma)
        return (dv, _zero_cotangent(threshold, dv),
                _zero_cotangent(gamma, dv), None)


def heaviside_sigmoid(v: torch.Tensor, threshold, gamma) -> torch.Tensor:
    """Heaviside spike with the fast-sigmoid surrogate gradient (Zenke &
    Ganguli 2018); ``gamma`` is the reference's ``scale``."""
    return _Heaviside.apply(v, threshold, gamma, SpikeFuncType.FastSigmoid)


def heaviside_phi(v: torch.Tensor, threshold, gamma) -> torch.Tensor:
    """Heaviside spike with the triangular surrogate gradient
    (spike_funcs.py:69-79)."""
    return _Heaviside.apply(v, threshold, gamma, SpikeFuncType.Phi)


SPIKE_FN_REGISTRY: dict[SpikeFuncType, Callable] = {
    SpikeFuncType.FastSigmoid: heaviside_sigmoid,
    SpikeFuncType.Phi: heaviside_phi,
}


def resolve_spike_fn(spike_func) -> Callable:
    """Accept an enum member, a callable, or a string name (snn.py:77-79)."""
    if isinstance(spike_func, SpikeFuncType):
        return SPIKE_FN_REGISTRY[spike_func]
    if isinstance(spike_func, str):
        return SPIKE_FN_REGISTRY[SpikeFuncType[spike_func]]
    if callable(spike_func):
        return spike_func
    raise TypeError(f"Cannot resolve spike function from {spike_func!r}")
