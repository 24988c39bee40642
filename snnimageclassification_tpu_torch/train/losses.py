"""Spike regularizers.

Port of the JAX package's train/losses.py.  The reference ships an empty
``losses.py``; the regularizers it intended exist only as commented-out
sketches in its training step (snn.py:401-408).  This module implements
them as working, optional regularizers:

* :func:`l1_total_spike_count` -- ``1e-5 * sum(total spikes)`` (snn.py:404);
* :func:`l2_spikes_per_neuron` -- mean squared per-neuron spike count over
  batch and time (snn.py:405-407);
* :func:`mean_spike_count_per_neuron` -- the ``get_spikes_count_per_neuron``
  mean (snn.py:402, 408 with snn.py:261-270).

Each takes the hidden-state traces dict of ``models.apply(...,
return_hidden=True)`` (``{layer: tuple of (B, T, width)}``; the last
element of a spiking layer's tuple is its z trace) and returns a scalar.
The object forms :class:`L1TotalSpikeCount` and :class:`L2SpikesPerNeuron`
are also callable on ``(counts, weights)`` through ``from_counts``: both
sketches are functions of the per-neuron spike counts only, so a trainer
given one of them keeps the whole-network head (its ``_counts`` variants)
instead of the trace-returning time loop.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "l1_total_spike_count",
    "l2_spikes_per_neuron",
    "mean_spike_count_per_neuron",
    "L1TotalSpikeCount",
    "L2SpikesPerNeuron",
]

Hidden = Dict[str, Tuple[torch.Tensor, ...]]


def _spike_traces(hidden_states: Hidden, cfg=None):
    """z traces of the LIF-family layers (snn.py:403).  With an
    ``SNNConfig`` the reference's ``isinstance(layer, LIFLayer)`` filter
    applies (no Izhikevich, snn.py:268); without one every non-readout
    layer counts."""
    if cfg is not None:
        from ..ops.cells import ALIFConfig, LIFConfig

        by_name = dict(cfg.layer_configs)
        return [traces[-1] for name, traces in hidden_states.items()
                if type(by_name.get(name)) in (LIFConfig, ALIFConfig)]
    return [traces[-1] for name, traces in hidden_states.items()
            if name != "readout"]


def _zero() -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32)


def l1_total_spike_count(hidden_states: Hidden, scale: float = 1e-5,
                         cfg=None) -> torch.Tensor:
    """L1 penalty on the total number of spikes (snn.py:404)."""
    spikes = _spike_traces(hidden_states, cfg)
    if not spikes:
        return _zero()
    return scale * sum(s.sum() for s in spikes)


def l2_spikes_per_neuron(hidden_states: Hidden, scale: float = 1e-5,
                         cfg=None) -> torch.Tensor:
    """L2 penalty on per-neuron spike counts (snn.py:405-407): per layer,
    square the count summed over batch and time, then average over
    neurons."""
    spikes = _spike_traces(hidden_states, cfg)
    if not spikes:
        return _zero()
    return scale * sum((s.sum(dim=(0, 1)) ** 2).mean() for s in spikes)


def mean_spike_count_per_neuron(hidden_states: Hidden,
                                cfg=None) -> torch.Tensor:
    """Mean per-neuron spike count (snn.py:402 with :261-270)."""
    spikes = _spike_traces(hidden_states, cfg)
    if not spikes:
        return _zero()
    return torch.cat([s.sum(dim=(0, 1)) for s in spikes]).mean()


class _CountRegularizer:
    """Callable on hidden traces and, through ``from_counts``, on
    ``({layer: (B, H) spike counts}, per-sample weights (B,))``; with
    ``c_h = sum_b w_b counts[b, h]`` the two agree exactly when the traces
    are masked by the same weights."""

    kind: str = ""  # "l1" | "l2"

    def __init__(self, scale: float = 1e-5, cfg=None):
        self.scale = float(scale)
        self.cfg = cfg

    def __call__(self, hidden_states: Hidden) -> torch.Tensor:
        raise NotImplementedError

    def from_counts(self, counts: Dict[str, torch.Tensor],
                    w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1TotalSpikeCount(_CountRegularizer):
    """Object form of :func:`l1_total_spike_count`:
    ``scale * sum_h c_h``."""

    kind = "l1"

    def __call__(self, hidden_states):
        return l1_total_spike_count(hidden_states, self.scale, self.cfg)

    def from_counts(self, counts, w):
        if not counts:
            return _zero()
        return self.scale * sum(
            (w @ c.to(torch.float32)).sum() for c in counts.values())


class L2SpikesPerNeuron(_CountRegularizer):
    """Object form of :func:`l2_spikes_per_neuron`:
    ``scale * mean_h c_h^2``."""

    kind = "l2"

    def __call__(self, hidden_states):
        return l2_spikes_per_neuron(hidden_states, self.scale, self.cfg)

    def from_counts(self, counts, w):
        if not counts:
            return _zero()
        return self.scale * sum(
            ((w @ c.to(torch.float32)) ** 2).mean() for c in counts.values())
