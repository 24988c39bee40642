"""Training: losses, spike regularizers, the masked Adam and a minimal
:class:`Trainer`, the checkpoint manager (port of the JAX package's
train/)."""
from .losses import (  # noqa: F401
    L1TotalSpikeCount,
    L2SpikesPerNeuron,
    l1_total_spike_count,
    l2_spikes_per_neuron,
    mean_spike_count_per_neuron,
)
from .checkpoint import CheckpointManager, LoadCheckpointMode  # noqa: F401
from .trainer import (  # noqa: F401
    ES_TOL,
    MaskedAdam,
    Trainer,
    checkpoint_selected,
    default_criterion,
    encode_on_device,
    host_snapshot,
    make_optimizer,
    nll_loss,
)
