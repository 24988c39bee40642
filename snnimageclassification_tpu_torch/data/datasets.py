"""Encoding settings carried beside raw pixel batches.

The port's own copy of the JAX package's ``data/datasets.py:EncodeConfig``;
the loaders come with a later part of the port.
"""
from __future__ import annotations

import dataclasses

__all__ = ["EncodeConfig"]


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """How raw pixel batches become model inputs.

    ``as_timeseries=False`` feeds pixels as a constant-over-time input
    (the model repeats them across T, snn.py:159-171); otherwise the spike
    encoder runs on the device with these settings (defaults match
    ToSpikes, datasets.py:16-40, including quirk Q2's degenerate tau).
    """

    as_timeseries: bool = True
    n_steps: int = 100
    use_periods: bool = False
    tau: float = 20.0 * 1e-3
    thr: float = 0.2
    epsilon: float = 1e-7
