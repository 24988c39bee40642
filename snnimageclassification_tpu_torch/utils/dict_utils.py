"""Nested-mapping utilities.

The port's own copy of the JAX package's utils/dict_utils.py (reference
``src/modules/utils.py:28-40``): the recursive dict merge of the checkpoint
meta writer.
"""
from __future__ import annotations

import collections.abc

__all__ = ["mapping_update_recursively"]


def mapping_update_recursively(d: dict, u: dict) -> dict:
    """Update mapping ``d`` with ``u``, recursing into nested mappings."""
    for k, v in u.items():
        if isinstance(v, collections.abc.Mapping):
            d[k] = mapping_update_recursively(d.get(k, {}), v)
        else:
            d[k] = v
    return d
