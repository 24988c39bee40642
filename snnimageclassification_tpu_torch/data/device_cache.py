"""Device-resident dataset cache with batch gather on the device.

The port's counterpart of the JAX package's data/device_cache.py, shared
by the trainers: a dataset under the size limit is copied to the device
once, and per-batch work reduces to moving a small index array and
gathering rows on the device instead of uploading pixels every batch.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = ["DeviceDataCache", "pad_rows"]


def pad_rows(idx: np.ndarray, target: int):
    """Pad a 1-D index array up to ``target`` rows; returns (padded, w).

    Padding rows index row 0 (any valid row works) and carry weight 0, so
    weighted losses and metrics stay exact while every batch of an epoch
    has one shape (the kernels' launches and plans stay those of a full
    batch)."""
    n = idx.shape[0]
    w = np.ones((n,), np.float32)
    if target <= n:
        return idx, w
    return np.pad(idx, (0, target - n)), np.pad(w, (0, target - n))


class DeviceDataCache:
    """Weak-keyed per-loader device copies.

    Weak keying means a garbage-collected loader frees its device copy, and
    a new loader allocated at the same address can never hit a stale
    entry."""

    def __init__(self, limit_bytes: int = 512 * 1024 * 1024):
        self.limit_bytes = limit_bytes
        self._cache = weakref.WeakKeyDictionary()

    def fits(self, loader) -> bool:
        return 0 < loader.x.nbytes <= self.limit_bytes

    def arrays(self, loader, device: torch.device):
        """The loader's ``(x float32, y int64)`` on ``device``, copied
        once."""
        cached = self._cache.get(loader)
        if cached is not None and cached[0] == device:
            return cached[1], cached[2]
        x = torch.as_tensor(np.asarray(loader.x, np.float32), device=device)
        y = torch.as_tensor(np.asarray(loader.y), device=device).to(
            torch.int64)
        self._cache[loader] = (device, x, y)
        return x, y

    def batches(self, loader, device: torch.device):
        """One epoch of ``(x, y, w)`` device batches gathered by index.
        Every batch is padded up to ``loader.batch_size`` rows with weight-0
        rows, so a remainder batch runs at the full batch's shape."""
        x_dev, y_dev = self.arrays(loader, device)
        for idx in loader.iter_indices():
            idx_p, w = pad_rows(np.asarray(idx), loader.batch_size)
            idx_d = torch.as_tensor(idx_p, device=device)
            yield (x_dev.index_select(0, idx_d), y_dev.index_select(0, idx_d),
                   torch.as_tensor(w, device=device))
