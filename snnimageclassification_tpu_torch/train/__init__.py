"""Training: losses, spike regularizers, the masked Adam and a minimal
:class:`Trainer` (port of the JAX package's train/)."""
from .losses import (  # noqa: F401
    L1TotalSpikeCount,
    L2SpikesPerNeuron,
    l1_total_spike_count,
    l2_spikes_per_neuron,
    mean_spike_count_per_neuron,
)
from .trainer import (  # noqa: F401
    MaskedAdam,
    Trainer,
    default_criterion,
    make_optimizer,
    nll_loss,
)
