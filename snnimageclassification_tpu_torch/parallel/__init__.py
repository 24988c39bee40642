"""Several models at once: multi-seed ensembles (the meshes and parallel
strategies of the JAX package's parallel/ are not ported yet)."""
from .ensemble import (  # noqa: F401
    EnsembleTrainer,
    init_ensemble,
    majority_vote,
    replica,
)
