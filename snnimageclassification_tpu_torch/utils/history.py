"""Training-history container.

The port's own copy of the JAX package's utils/history.py (reference
``src/modules/utils.py:43-99``, ``LossHistory``): a dict of named metric
series with concat/append/min helpers and a matplotlib plot, which imports
matplotlib only when called.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LossHistory"]


class LossHistory:
    def __init__(self, container: Optional[Dict[str, List[float]]] = None):
        self.container: Dict[str, List[float]] = defaultdict(list)
        if container is not None:
            self.container.update(container)

    def __getitem__(self, item):
        return self.container[item]

    def __setitem__(self, key, value):
        self.container[key] = value

    def __contains__(self, item):
        return item in self.container

    def __iter__(self):
        return iter(self.container)

    def __len__(self):
        return len(self.container)

    def items(self):
        return self.container.items()

    def concat(self, other):
        """Extend each series; scalars are appended (utils.py:67-72)."""
        for key, values in other.items():
            if isinstance(values, list):
                self.container[key].extend(values)
            else:
                self.container[key].append(values)

    def append(self, key, value):
        self.container[key].append(value)

    def min(self, key: str = "val"):
        if key in self:
            return min(self[key])
        return np.inf

    def min_item(self, key: str = "val"):
        if key in self:
            argmin = int(np.argmin(self[key]))
            return {k: v[argmin] for k, v in self.items()}
        return None

    def to_dict(self) -> Dict[str, List[float]]:
        return {k: list(v) for k, v in self.container.items()}

    def plot(self, save_path=None, show=False):
        """Line plot of every series (utils.py:87-99)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 10))
        for name, values in self.items():
            ax.plot(values, label=name, linewidth=3)
        ax.set_xlabel("Epoch [-]", fontsize=16)
        ax.set_ylabel("Loss [-]", fontsize=16)
        ax.legend(fontsize=16)
        if save_path is not None:
            plt.savefig(save_path, dpi=300)
        if show:  # pragma: no cover - interactive only
            plt.show()
        plt.close(fig)
