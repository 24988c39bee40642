"""Model-level configuration.

Port of the JAX package's models/config.py: a frozen dataclass mirroring
the reference ``SNN.__init__`` surface (snn.py:51-93) that expands into
per-layer configs (ops/cells.py), with the same fields and defaults.  The
JAX package's ``remat`` (a ``jax.checkpoint`` knob) has no counterpart
here, and its ``use_pallas`` is ``use_kernels``: use the hand-written CUDA
kernels where a config is eligible.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple, Union

from ..ops.cells import (
    ALIFConfig,
    LAYER_TYPE_TO_CONFIG,
    LayerType,
    ReadoutConfig,
)
from ..ops.surrogate import SpikeFuncType

__all__ = ["ReadoutMth", "ForwardMth", "SNNConfig"]


class ReadoutMth(enum.Enum):
    """``RNN`` = max-over-time logits (snn.py:228); ``TEMPORAL_FILTER`` =
    the decayed temporal sum (snn.py:229)."""

    RNN = 0
    TEMPORAL_FILTER = 1


class ForwardMth(enum.Enum):
    """Only ``LAYER_THEN_TIME`` (snn.py:209-214) is implemented."""

    LAYER_THEN_TIME = 0
    TIME_THEN_LAYER = 1


def _as_tuple(x) -> Tuple[int, ...]:
    if x is None:
        return ()
    if isinstance(x, int):
        return (x,)
    return tuple(x)


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Architecture + simulation config for an SNN classifier.

    ``n_hidden_neurons`` may be an int or a sequence; layer
    hyperparameters flow to every hidden layer (snn.py:106-142)."""

    input_size: int
    output_size: int
    n_hidden_neurons: Union[int, Sequence[int], None] = None
    use_recurrent_connection: bool = True
    use_rec_eye_mask: bool = True
    dt: float = 1e-3
    int_time_steps: int = 100
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
    hidden_layer_type: LayerType = LayerType.LIF
    readout_mth: ReadoutMth = ReadoutMth.RNN
    readout_filter_decay: float = 0.9
    # Per-layer hyperparameter overrides; None -> layer-config default.
    threshold: Optional[float] = None
    gamma: Optional[float] = None
    tau_m: Optional[float] = None
    tau_a: Optional[float] = None
    tau_out: Optional[float] = None
    beta: Optional[float] = None
    learn_beta: bool = False
    # State/accumulation dtype; the kernels need "float32".
    compute_dtype: str = "float32"
    # Matmul operand dtype; None follows compute_dtype.  "bfloat16" with
    # float32 compute multiplies bf16 operands with float32 accumulation.
    matmul_dtype: Optional[str] = None
    use_kernels: bool = True

    @property
    def matmul_dtype_eff(self) -> str:
        return (self.compute_dtype if self.matmul_dtype is None
                else self.matmul_dtype)

    def __post_init__(self):
        object.__setattr__(
            self, "n_hidden_neurons", _as_tuple(self.n_hidden_neurons)
        )
        if isinstance(self.hidden_layer_type, str):
            object.__setattr__(
                self, "hidden_layer_type", LayerType[self.hidden_layer_type]
            )
        if isinstance(self.spike_func, str):
            object.__setattr__(self, "spike_func",
                               SpikeFuncType[self.spike_func])

    def _hidden_overrides(self) -> dict:
        cfg_cls = LAYER_TYPE_TO_CONFIG[self.hidden_layer_type]
        over = dict(
            use_recurrent_connection=self.use_recurrent_connection,
            use_rec_eye_mask=self.use_rec_eye_mask,
            dt=self.dt,
            spike_func=self.spike_func,
        )
        for name in ("threshold", "gamma", "tau_m"):
            if getattr(self, name) is not None:
                over[name] = getattr(self, name)
        if cfg_cls is ALIFConfig:
            over["learn_beta"] = self.learn_beta
            if self.tau_a is not None:
                over["tau_a"] = self.tau_a
            if self.beta is not None:
                over["beta"] = self.beta
        return over

    @property
    def layer_configs(self) -> Tuple[Tuple[str, object], ...]:
        """Ordered (name, layer_config) pairs: "input", "hidden_i"...,
        "readout" (snn.py:103-147)."""
        cfg_cls = LAYER_TYPE_TO_CONFIG[self.hidden_layer_type]
        over = self._hidden_overrides()
        layers = []
        hidden = _as_tuple(self.n_hidden_neurons)
        if hidden:
            layers.append(("input", cfg_cls(input_size=self.input_size,
                                            output_size=hidden[0], **over)))
            for i, hn in enumerate(hidden[:-1]):
                layers.append((f"hidden_{i}", cfg_cls(
                    input_size=hn, output_size=hidden[i + 1], **over)))
            readout_in = hidden[-1]
        else:
            readout_in = self.input_size
        readout_kw = {}
        if self.tau_out is not None:
            readout_kw["tau_out"] = self.tau_out
        layers.append(("readout", ReadoutConfig(
            input_size=readout_in, output_size=self.output_size, dt=self.dt,
            **readout_kw)))
        return tuple(layers)
