"""Semantic ops (surrogates, cells, encoding, temporal reductions) and the
whole-network head kernels (forward, training forward, backward) with
their plain PyTorch versions."""
from .cells import LayerType  # noqa: F401
from .encoding import ToSpikes, encode_spikes  # noqa: F401
from .surrogate import SpikeFuncType, heaviside_phi, heaviside_sigmoid  # noqa: F401
from .temporal import batchwise_temporal_filter, temporal_max  # noqa: F401
