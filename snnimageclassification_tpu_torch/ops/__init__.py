"""Semantic ops (surrogates, cells, encoding, temporal reductions) and the
kernels with their plain PyTorch versions: the whole-network head and the
z-emitting first layer (fused.py), the layers past the first and the deep
network's head (fused_mid.py), a two-hidden-layer network as one pair
(fused2.py), and their Izhikevich counterparts (the head
and first layer in fused_izh.py, the scan over a layer's currents in
izh.py); for layers too wide for those and for currents that come from a
product, the encoded input product (encode.py) and the scan over a layer's
currents, recurrent (rec_scan.py) or feedforward (scan.py)."""
from .cells import LayerType  # noqa: F401
from .encode import encoded_input_matmul  # noqa: F401
from .encoding import ToSpikes, encode_spikes  # noqa: F401
from .fused_izh import (  # noqa: F401
    fused_encode_izh_scan,
    fused_encode_izh_scan_head,
    fused_encode_izh_scan_head_counts,
)
from .izh import izh_kernel_params, izh_scan  # noqa: F401
from .rec_scan import rec_alif_scan, rec_lif_scan  # noqa: F401
from .scan import alif_scan, lif_scan  # noqa: F401
from .surrogate import SpikeFuncType, heaviside_phi, heaviside_sigmoid  # noqa: F401
from .temporal import batchwise_temporal_filter, temporal_max  # noqa: F401
