"""Temporal reductions over readout traces.

Port of the JAX package's ops/temporal.py (reference
``src/modules/utils.py:11-25`` and snn.py:228-229).
"""
from __future__ import annotations

import torch

__all__ = ["batchwise_temporal_filter", "temporal_max"]


def batchwise_temporal_filter(x: torch.Tensor, decay: float = 0.9,
                              time_axis: int = 1) -> torch.Tensor:
    """``sum_t decay**(T-1-t) * x[:, t]`` over ``time_axis``."""
    time_steps = x.shape[time_axis]
    powers = torch.arange(time_steps - 1, -1, -1, dtype=x.dtype,
                          device=x.device)
    weights = torch.pow(torch.tensor(decay, dtype=x.dtype, device=x.device),
                        powers)
    shape = [1] * x.dim()
    shape[time_axis] = time_steps
    return torch.sum(x * weights.reshape(shape), dim=time_axis)


def temporal_max(x: torch.Tensor, time_axis: int = 1) -> torch.Tensor:
    """Max over time with first-argmax semantics: the value at the first
    maximal step, so a backward routes the whole cotangent there, as
    ``torch.max`` does."""
    idx = torch.argmax(x, dim=time_axis, keepdim=True)
    return torch.take_along_dim(x, idx, dim=time_axis).squeeze(time_axis)
