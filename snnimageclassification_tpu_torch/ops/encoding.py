"""Image -> spike-train encoding on tensors.

Port of the JAX package's ops/encoding.py, with the same semantics
(reference ``src/datasets/datasets.py:16-97``):

* ``pixels_to_firing_periods``: LIF-charge-time latency
  ``T = tau * ln(x / (x - thr))`` in float32 for supra-threshold pixels,
  ``t_max`` for sub-threshold ones, truncated toward zero to int32.
* TTFS ``firing_times_to_spikes``: one spike at ``t = T`` iff ``T < n_steps``.
* Periodic ``firing_periods_to_spikes``: period clamped into
  ``[1, n_steps - 1]``; spike wherever ``(t - p) % p == 0`` and ``t >= p``.

Quirk Q2 is kept: the default ``tau = 20e-3`` truncates every
supra-threshold latency to 0.  Rasters are float32 ``(T, ..., F)`` from the
low-level functions and ``(..., T, F)`` from :func:`encode_spikes`.

The functions run on the device their input lies on; :class:`ToSpikes`,
an entry point, takes an explicit ``device``.
"""
from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = [
    "pixels_to_firing_periods",
    "firing_times_to_spikes",
    "firing_periods_to_spikes",
    "firing_periods_to_spikes_loop",
    "firing_periods_to_spikes_clip",
    "spike_row",
    "encode_spikes",
    "ToSpikes",
]


def pixels_to_firing_periods(
    x: torch.Tensor,
    *,
    t_max: float,
    tau: float = 20.0 * 1e-3,
    thr: float = 0.2,
    epsilon: float = 1e-7,
) -> torch.Tensor:
    """First-spike latency of a current-based LIF neuron charged by pixel x
    (datasets.py:42-54); ``x`` float32 in [0, 1] -> int32 latencies."""
    x = x.to(torch.float32)
    sub = x < thr
    xc = torch.clamp(x, thr + epsilon, 1.0e9)
    latency = tau * torch.log(xc / (xc - thr))
    latency = torch.where(sub, torch.full_like(latency, t_max), latency)
    return latency.to(torch.int32)  # truncates toward zero; latencies >= 0


def _steps(n_steps: int, like: torch.Tensor) -> torch.Tensor:
    t = torch.arange(n_steps, dtype=like.dtype, device=like.device)
    return t.reshape((n_steps,) + (1,) * like.dim())


def _mod_is_zero(delta: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``delta % p == 0`` with floored modulo, where ``x % 0 == 0`` as in
    XLA (PyTorch raises on an integer division by zero)."""
    safe = torch.where(p == 0, torch.ones_like(p), p)
    return (p == 0) | (torch.remainder(delta, safe) == 0)


def firing_times_to_spikes(firing_times: torch.Tensor,
                           n_steps: int) -> torch.Tensor:
    """TTFS raster (datasets.py:81-86): ``(..., F)`` ints -> float32
    ``(n_steps, ..., F)``."""
    ft = firing_times[None]
    spikes = (_steps(n_steps, firing_times) == ft) & (ft < n_steps)
    return spikes.to(torch.float32)


def firing_periods_to_spikes(firing_periods: torch.Tensor,
                             n_steps: int) -> torch.Tensor:
    """Periodic raster with the period clamped into [1, n_steps-1]
    (datasets.py:72-79)."""
    p = torch.clamp(firing_periods, 1, n_steps - 1)[None]
    delta = _steps(n_steps, firing_periods) - p
    return (_mod_is_zero(delta, p) & (delta >= 0)).to(torch.float32)


def firing_periods_to_spikes_loop(firing_periods: torch.Tensor,
                                  n_steps: int) -> torch.Tensor:
    """Dead reference variant #1 (datasets.py:56-62): first spike at
    ``clip(p, 0, n_steps-1)``, repeating with the unclamped stride ``p``;
    ``p <= 0`` gives an all-zero row (the reference crashes on ``p == 0``)."""
    p = firing_periods[None]
    delta = _steps(n_steps, firing_periods) - torch.clamp(p, 0, n_steps - 1)
    p_safe = torch.where(p >= 1, p, torch.ones_like(p))
    spikes = (torch.remainder(delta, p_safe) == 0) & (delta >= 0) & (p >= 1)
    return spikes.to(torch.float32)


def firing_periods_to_spikes_clip(firing_periods: torch.Tensor,
                                  n_steps: int) -> torch.Tensor:
    """Dead reference variant #2 (datasets.py:63-70): start clamped to
    ``[0, n_steps-1]``, modulus by the raw period; NumPy's ``x % 0 == 0``
    makes ``p == 0`` spike at every step, and a negative period rasters
    like ``|p|`` (floored modulo)."""
    p = firing_periods[None]
    delta = _steps(n_steps, firing_periods) - torch.clamp(p, 0, n_steps - 1)
    return (_mod_is_zero(delta, p) & (delta >= 0)).to(torch.float32)


def spike_row(lat: torch.Tensor, step: int, n_steps: int,
              use_periods: bool) -> torch.Tensor:
    """Bool spike row of integer latencies at one time ``step`` -- one
    slice of :func:`firing_periods_to_spikes` / :func:`firing_times_to_spikes`
    without the ``(T, ..., F)`` raster."""
    if use_periods:
        p = torch.clamp(lat, 1, n_steps - 1)
        delta = step - p
        return _mod_is_zero(delta, p) & (delta >= 0)
    return lat == step


def encode_spikes(
    x: torch.Tensor,
    *,
    n_steps: int,
    use_periods: bool = False,
    t_max: float | None = None,
    tau: float = 20.0 * 1e-3,
    thr: float = 0.2,
    epsilon: float = 1e-7,
) -> torch.Tensor:
    """Pixels ``(..., F)`` -> float32 spike train ``(..., T, F)``
    (datasets.py:93-97, batched)."""
    t_max = float(n_steps) if t_max is None else t_max
    periods = pixels_to_firing_periods(
        x, t_max=t_max, tau=tau, thr=thr, epsilon=epsilon
    )
    gen = firing_periods_to_spikes if use_periods else firing_times_to_spikes
    return torch.movedim(gen(periods, n_steps), 0, -2)


class ToSpikes:
    """The reference's ToSpikes transform (datasets.py:16-97).

    ``__call__`` on one flattened image ``(F,)`` returns a float32
    ``(n_steps, F)`` raster on ``device``."""

    def __init__(
        self,
        n_steps: int,
        t_max: float | None = None,
        tau: float = 20.0 * 1e-3,
        thr: float = 0.2,
        use_periods: bool = False,
        epsilon: float = 1e-7,
        *,
        device="cuda",
    ):
        self.n_steps = n_steps
        self.t_max = n_steps if t_max is None else t_max
        self.tau = tau
        self.thr = thr
        self.epsilon = epsilon
        self.use_periods = use_periods
        self.device = resolve_device(device)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def pixels_to_firing_periods(self, x) -> torch.Tensor:
        return pixels_to_firing_periods(
            self._tensor(x, torch.float32), t_max=self.t_max, tau=self.tau,
            thr=self.thr, epsilon=self.epsilon,
        )

    def firing_times_to_spikes(self, firing_times) -> torch.Tensor:
        return firing_times_to_spikes(self._tensor(firing_times), self.n_steps)

    def firing_periods_to_spikes(self, firing_periods) -> torch.Tensor:
        return firing_periods_to_spikes(self._tensor(firing_periods),
                                        self.n_steps)

    def firing_periods_to_spikes_loop(self, firing_periods) -> torch.Tensor:
        return firing_periods_to_spikes_loop(self._tensor(firing_periods),
                                             self.n_steps)

    def firing_periods_to_spikes_clip(self, firing_periods) -> torch.Tensor:
        return firing_periods_to_spikes_clip(self._tensor(firing_periods),
                                             self.n_steps)

    def __call__(self, x) -> torch.Tensor:
        x = self._tensor(x, torch.float32).reshape(-1)
        return encode_spikes(
            x, n_steps=self.n_steps, use_periods=self.use_periods,
            t_max=self.t_max, tau=self.tau, thr=self.thr,
            epsilon=self.epsilon,
        )
