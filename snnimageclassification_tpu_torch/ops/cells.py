"""Spiking-neuron cells: configs, states, parameter init and one-step
dynamics on tensors.

Port of the JAX package's ops/cells.py (reference
``src/modules/spiking_layers.py``):

* **LIF**: ``V' = (alpha V + I_in + I_rec) (1 - Z)`` with the spike
  detached in the reset; ``Z' = spike_fn(V', threshold, gamma)``.
* **ALIF**: adds ``a' = rho a + Z`` and the dynamic threshold
  ``threshold + beta a'``.
* **Izhikevich**: quadratic membrane, reset to ``c`` and jump ``d``.
* **Readout**: ``V' = kappa V + x @ W + b``.

The recurrent current and ``a`` both use the previous step's ``Z``
(spiking_layers.py:165, 236).  Defaults keep quirk Q1 (effective gammas
LIF=1.0, ALIF=0.3, Izhikevich=1.0) and the learnable-beta init quirk
(beta ~ N(0, threshold^2)).  Params are ``{leaf: tensor}`` dicts in the
JAX layout: ``w_in`` is ``(in, out)``.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional

import torch

from .surrogate import SpikeFuncType, resolve_spike_fn

__all__ = [
    "LayerType",
    "LIFConfig",
    "ALIFConfig",
    "IzhikevichConfig",
    "ReadoutConfig",
    "LIFState",
    "ALIFState",
    "IzhikevichState",
    "ReadoutState",
    "lif_init_state",
    "alif_init_state",
    "izhikevich_init_state",
    "readout_init_state",
    "lif_step",
    "alif_step",
    "izhikevich_step",
    "readout_step",
    "lif_init_params",
    "alif_init_params",
    "izhikevich_init_params",
    "readout_init_params",
    "masked_recurrent",
    "LAYER_TYPE_TO_CONFIG",
]


class LayerType(enum.Enum):
    """Mirror of the reference's LayerType enum (spiking_layers.py:11-14)."""

    LIF = enum.auto()
    ALIF = enum.auto()
    Izhikevich = enum.auto()


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LIFConfig:
    """LIF layer (spiking_layers.py:124-130); ``alpha = exp(-dt/tau_m)``."""

    input_size: int
    output_size: int
    use_recurrent_connection: bool = True
    use_rec_eye_mask: bool = True
    dt: float = 1e-3
    tau_m: Optional[float] = None  # default: 10*dt
    threshold: float = 1.0
    gamma: float = 1.0
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid

    layer_type = LayerType.LIF

    @property
    def tau_m_eff(self) -> float:
        return 10.0 * self.dt if self.tau_m is None else self.tau_m

    @property
    def alpha(self) -> float:
        return math.exp(-self.dt / self.tau_m_eff)

    @property
    def spike_fn(self) -> Callable:
        return resolve_spike_fn(self.spike_func)


@dataclasses.dataclass(frozen=True)
class ALIFConfig(LIFConfig):
    """ALIF layer (spiking_layers.py:201-210).  ``learn_beta`` puts
    ``beta`` in the params; it starts at N(0, threshold^2) and never
    trains (quirk Q3)."""

    tau_m: Optional[float] = None  # default: 20*dt
    tau_a: Optional[float] = None  # default: 200*dt
    beta: float = 1.6
    threshold: float = 0.03
    gamma: float = 0.3
    learn_beta: bool = False

    layer_type = LayerType.ALIF

    @property
    def tau_m_eff(self) -> float:
        return 20.0 * self.dt if self.tau_m is None else self.tau_m

    @property
    def tau_a_eff(self) -> float:
        return 200.0 * self.dt if self.tau_a is None else self.tau_a

    @property
    def rho(self) -> float:
        return math.exp(-self.dt / self.tau_a_eff)


@dataclasses.dataclass(frozen=True)
class IzhikevichConfig(LIFConfig):
    """Izhikevich layer (spiking_layers.py:285-298)."""

    C: float = 100.0
    v_rest: float = -60.0
    v_th: float = -40.0
    k: float = 0.7
    a: float = 0.03
    b: float = -2.0
    c: float = -50.0
    d: float = 100.0
    v_peak: float = 35.0
    gamma: float = 1.0

    layer_type = LayerType.Izhikevich


@dataclasses.dataclass(frozen=True)
class ReadoutConfig:
    """Readout leaky integrator (spiking_layers.py:356-408)."""

    input_size: int
    output_size: int
    dt: float = 1e-3
    tau_out: Optional[float] = None  # default: 10*dt

    use_recurrent_connection = False

    @property
    def tau_out_eff(self) -> float:
        return 10.0 * self.dt if self.tau_out is None else self.tau_out

    @property
    def kappa(self) -> float:
        return math.exp(-self.dt / self.tau_out_eff)


LAYER_TYPE_TO_CONFIG = {
    LayerType.LIF: LIFConfig,
    LayerType.ALIF: ALIFConfig,
    LayerType.Izhikevich: IzhikevichConfig,
}


# ---------------------------------------------------------------------------
# States
# ---------------------------------------------------------------------------
class LIFState(NamedTuple):
    v: torch.Tensor  # membrane potential (B, out)
    z: torch.Tensor  # previous spikes   (B, out)


class ALIFState(NamedTuple):
    v: torch.Tensor  # membrane potential  (B, out)
    a: torch.Tensor  # adaptation variable (B, out)
    z: torch.Tensor  # previous spikes     (B, out)


class IzhikevichState(NamedTuple):
    v: torch.Tensor  # membrane potential (B, out)
    u: torch.Tensor  # recovery variable  (B, out)
    z: torch.Tensor  # previous spikes    (B, out)


class ReadoutState(NamedTuple):
    v: torch.Tensor  # integrator potential (B, out)


def _zeros(cfg, batch_size, dtype, device):
    return torch.zeros((batch_size, cfg.output_size), dtype=dtype,
                       device=device)


def lif_init_state(cfg: LIFConfig, batch_size: int, dtype=torch.float32,
                   device="cpu") -> LIFState:
    """Zero state (spiking_layers.py:140-154)."""
    return LIFState(v=_zeros(cfg, batch_size, dtype, device),
                    z=_zeros(cfg, batch_size, dtype, device))


def alif_init_state(cfg: ALIFConfig, batch_size: int, dtype=torch.float32,
                    device="cpu") -> ALIFState:
    return ALIFState(v=_zeros(cfg, batch_size, dtype, device),
                     a=_zeros(cfg, batch_size, dtype, device),
                     z=_zeros(cfg, batch_size, dtype, device))


def izhikevich_init_state(cfg: IzhikevichConfig, batch_size: int,
                          dtype=torch.float32,
                          device="cpu") -> IzhikevichState:
    """V starts at v_rest (spiking_layers.py:317-322)."""
    return IzhikevichState(
        v=torch.full((batch_size, cfg.output_size), cfg.v_rest, dtype=dtype,
                     device=device),
        u=_zeros(cfg, batch_size, dtype, device),
        z=_zeros(cfg, batch_size, dtype, device),
    )


def readout_init_state(cfg: ReadoutConfig, batch_size: int,
                       dtype=torch.float32, device="cpu") -> ReadoutState:
    return ReadoutState(v=_zeros(cfg, batch_size, dtype, device))


# ---------------------------------------------------------------------------
# Parameter initialization (draws from ``generator`` in a fixed order)
# ---------------------------------------------------------------------------
def _normal(generator: torch.Generator, shape, std, dtype, device):
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return (std * x).to(device)


def lif_init_params(cfg: LIFConfig, generator: torch.Generator,
                    dtype=torch.float32, device="cpu") -> dict:
    """Weights ~ N(0, threshold^2) (spiking_layers.py:132-138)."""
    params = {"w_in": _normal(generator, (cfg.input_size, cfg.output_size),
                              cfg.threshold, dtype, device)}
    if cfg.use_recurrent_connection:
        params["w_rec"] = _normal(
            generator, (cfg.output_size, cfg.output_size), cfg.threshold,
            dtype, device)
    return params


def alif_init_params(cfg: ALIFConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cpu") -> dict:
    params = lif_init_params(cfg, generator, dtype, device)
    if cfg.learn_beta:
        # Quirk: the weight-init sweep also draws the learnable beta
        # (snn.py:149-157), so it starts near zero, not at cfg.beta.
        params["beta"] = _normal(generator, (), cfg.threshold, dtype, device)
    return params


def izhikevich_init_params(cfg: IzhikevichConfig, generator: torch.Generator,
                           dtype=torch.float32, device="cpu") -> dict:
    """Weights ~ N(0, 1) (spiking_layers.py:300-306)."""
    params = {"w_in": _normal(generator, (cfg.input_size, cfg.output_size),
                              1.0, dtype, device)}
    if cfg.use_recurrent_connection:
        params["w_rec"] = _normal(
            generator, (cfg.output_size, cfg.output_size), 1.0, dtype, device)
    return params


def readout_init_params(cfg: ReadoutConfig, generator: torch.Generator,
                        dtype=torch.float32, device="cpu") -> dict:
    """W ~ N(0, 1), b = 0 (spiking_layers.py:383-385)."""
    return {
        "w_in": _normal(generator, (cfg.input_size, cfg.output_size), 1.0,
                        dtype, device),
        "b": torch.zeros((cfg.output_size,), dtype=dtype, device=device),
    }


def masked_recurrent(cfg, params: dict) -> Optional[torch.Tensor]:
    """Effective recurrent weights ``W_rec * (1 - I)`` (no self-connections,
    spiking_layers.py:50-51), or None without recurrence."""
    if not cfg.use_recurrent_connection:
        return None
    w_rec = params["w_rec"]
    if cfg.use_rec_eye_mask:
        eye = torch.eye(cfg.output_size, dtype=w_rec.dtype,
                        device=w_rec.device)
        w_rec = w_rec * (1.0 - eye)
    return w_rec


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _matmul(a: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    """``a @ w`` with ``w``'s dtype as the operand dtype and ``out_dtype``
    accumulation: a bf16 weight with float32 state multiplies bf16-rounded
    operands whose products are exact in float32."""
    if a.dtype == w.dtype == out_dtype:
        return a @ w
    return a.to(w.dtype).to(out_dtype) @ w.to(out_dtype)


def _currents(x, z, w_in, w_rec_eff, precomputed_input_current: bool):
    """Input + recurrent synaptic currents for one step; with
    ``precomputed_input_current`` ``x`` already is ``x @ w_in``."""
    i_in = x if precomputed_input_current else _matmul(x, w_in, x.dtype)
    if w_rec_eff is not None:
        i_in = i_in + _matmul(z, w_rec_eff, i_in.dtype)
    return i_in


def lif_step(cfg: LIFConfig, params: dict, state: LIFState, x, *,
             w_rec_eff=None, precomputed_input_current: bool = False):
    """One LIF step (spiking_layers.py:156-171)."""
    cur = _currents(x, state.z, params.get("w_in"), w_rec_eff,
                    precomputed_input_current)
    v = (cfg.alpha * state.v + cur) * (1.0 - state.z.detach())
    z = cfg.spike_fn(v, cfg.threshold, cfg.gamma)
    return z, LIFState(v=v, z=z)


def alif_step(cfg: ALIFConfig, params: dict, state: ALIFState, x, *,
              w_rec_eff=None, precomputed_input_current: bool = False):
    """One ALIF step (spiking_layers.py:229-243)."""
    cur = _currents(x, state.z, params.get("w_in"), w_rec_eff,
                    precomputed_input_current)
    v = (cfg.alpha * state.v + cur) * (1.0 - state.z.detach())
    a = cfg.rho * state.a + state.z
    beta = params["beta"] if cfg.learn_beta else cfg.beta
    z = cfg.spike_fn(v, cfg.threshold + beta * a, cfg.gamma)
    return z, ALIFState(v=v, a=a, z=z)


def izhikevich_step(cfg: IzhikevichConfig, params: dict,
                    state: IzhikevichState, x, *, w_rec_eff=None,
                    precomputed_input_current: bool = False):
    """One Izhikevich step (spiking_layers.py:337-353)."""
    cur = _currents(x, state.z, params.get("w_in"), w_rec_eff,
                    precomputed_input_current)
    is_reset = state.z.detach()
    dvdt = (cfg.k * (state.v - cfg.v_rest) * (state.v - cfg.v_th)
            - state.u + cur)
    v = ((state.v + cfg.dt * dvdt / cfg.C) * (1.0 - is_reset)
         + cfg.c * is_reset)
    dudt = cfg.a * (cfg.b * (state.v - cfg.v_rest) - state.u)
    u = (state.u + cfg.dt * dudt) + cfg.d * is_reset
    z = cfg.spike_fn(v, cfg.v_peak, cfg.gamma)
    return z, IzhikevichState(v=v, u=u, z=z)


def readout_step(cfg: ReadoutConfig, params: dict, state: ReadoutState, x, *,
                 w_rec_eff=None, precomputed_input_current: bool = False):
    """One readout step: ``kappa v + i + b`` (spiking_layers.py:402-408)."""
    i_in = (x if precomputed_input_current
            else _matmul(x, params["w_in"], x.dtype))
    v = cfg.kappa * state.v + i_in + params["b"]
    return v, ReadoutState(v=v)


STEP_FNS = {
    LIFConfig: lif_step,
    ALIFConfig: alif_step,
    IzhikevichConfig: izhikevich_step,
    ReadoutConfig: readout_step,
}

INIT_STATE_FNS = {
    LIFConfig: lif_init_state,
    ALIFConfig: alif_init_state,
    IzhikevichConfig: izhikevich_init_state,
    ReadoutConfig: readout_init_state,
}

INIT_PARAM_FNS = {
    LIFConfig: lif_init_params,
    ALIFConfig: alif_init_params,
    IzhikevichConfig: izhikevich_init_params,
    ReadoutConfig: readout_init_params,
}
