"""Small utilities: the checkpoint meta's recursive merge and the loss
history (port of the JAX package's utils/)."""
from .dict_utils import mapping_update_recursively  # noqa: F401
from .history import LossHistory  # noqa: F401
