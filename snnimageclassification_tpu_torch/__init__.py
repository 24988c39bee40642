"""snnimageclassification_tpu_torch: the PyTorch + CUDA port of
``snnimageclassification_tpu``.

Both the serving and the training path run on one NVIDIA Hopper card:
pixels -> on-device latencies -> the whole single-hidden-layer LIF/ALIF
network in hand-written CUDA kernels (ops/fused.py, csrc/): one for
inference behind the dynamic-batching :class:`InferenceServer`, a
training forward and a reverse-time backward behind
:class:`train.Trainer`.  Networks with more hidden layers run one kernel
pair a layer through the same entry points (ops/fused_mid.py).  Other
configs run a plain PyTorch time loop.
Entry points take ``device`` ("cuda" by default) and raise without CUDA
unless ``device="cpu"`` is passed.  Importing the package builds nothing;
the kernels are compiled at first use.
"""
__version__ = "0.1.0"

from .ops import (  # noqa: F401
    LayerType,
    SpikeFuncType,
    ToSpikes,
    batchwise_temporal_filter,
    encode_spikes,
    heaviside_phi,
    heaviside_sigmoid,
)
from .models import ForwardMth, ReadoutMth, SNNConfig  # noqa: F401
from .data import EncodeConfig  # noqa: F401
from .serve import InferenceServer, ServerStats  # noqa: F401
from .train import Trainer  # noqa: F401
