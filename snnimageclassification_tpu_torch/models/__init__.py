"""Model config, the functional SNN and parameter conversion."""
from .config import ForwardMth, ReadoutMth, SNNConfig  # noqa: F401
from .convert import params_from_jax, params_to_numpy  # noqa: F401
from .snn import (  # noqa: F401
    apply,
    apply_pixels,
    explain_dispatch,
    forward_logits,
    forward_logits_counts_pixels,
    forward_logits_pixels,
    init,
    init_state,
    param_labels,
    prediction_logits,
)
