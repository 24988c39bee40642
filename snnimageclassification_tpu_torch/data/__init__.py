"""Data-side settings shared with the model (the loaders are not ported yet)."""
from .datasets import EncodeConfig  # noqa: F401
