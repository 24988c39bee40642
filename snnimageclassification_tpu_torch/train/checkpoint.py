"""Checkpoint / resume subsystem.

Port of the JAX package's train/checkpoint.py (reference
``src/modules/snn.py:424-505``):

* per-epoch checkpoint files ``{folder}/{model_name}-epoch{N}.pth``
  holding ``{epoch, model_state_dict, optimizer_state_dict, loss}``,
  written with ``torch.save`` as the reference did (snn.py:434-449) and
  read back with ``torch.load(weights_only=True)``;
* a JSON meta file ``{model_name}-checkpoints.json`` tracking
  ``best -> path`` and ``epochs -> {N: path}`` (snn.py:45-48, 427-432,
  498-505), merged recursively on each save (utils.py:28-40); the ensemble
  trainer adds ``best_per_seed`` and ``ensemble`` to it;
* load by ``BEST_EPOCH`` / ``LAST_EPOCH`` (snn.py:29-31, 451-463,
  474-483);
* loss history reconstructed by re-reading all epoch checkpoints
  (snn.py:465-472).

A payload's ``model_state_dict`` is the ``{layer: {leaf: tensor}}`` params
tree on the host, its ``optimizer_state_dict`` a ``MaskedAdam.state_dict()``.
The port runs in one process, so every call writes.
"""
from __future__ import annotations

import enum
import json
import logging
import os
from typing import Any, Dict, Union

import torch

from ..utils.dict_utils import mapping_update_recursively
from ..utils.history import LossHistory

__all__ = ["LoadCheckpointMode", "CheckpointManager"]

logger = logging.getLogger(__name__)


class LoadCheckpointMode(enum.Enum):
    """Mirror of the reference enum (snn.py:29-31)."""

    BEST_EPOCH = enum.auto()
    LAST_EPOCH = enum.auto()


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    SAVE_EXT = ".pth"
    SUFFIX_SEP = "-"
    CHECKPOINTS_META_SUFFIX = "checkpoints"
    CHECKPOINT_BEST_KEY = "best"
    CHECKPOINT_EPOCHS_KEY = "epochs"
    CHECKPOINT_EPOCH_KEY = "epoch"
    CHECKPOINT_LOSS_KEY = "loss"
    CHECKPOINT_OPTIMIZER_STATE_DICT_KEY = "optimizer_state_dict"
    CHECKPOINT_STATE_DICT_KEY = "model_state_dict"

    def __init__(self, checkpoint_folder: str = "checkpoints",
                 model_name: str = "snn"):
        self.checkpoint_folder = checkpoint_folder
        self.model_name = model_name

    # -- paths --------------------------------------------------------------
    @property
    def checkpoints_meta_path(self) -> str:
        """Meta JSON path (snn.py:96-98)."""
        return (
            f"{self.checkpoint_folder}/{self.model_name}"
            f"{self.SUFFIX_SEP}{self.CHECKPOINTS_META_SUFFIX}.json"
        )

    def checkpoint_path(self, epoch: int = -1) -> str:
        """Per-epoch file path (snn.py:424-425)."""
        return (
            f"{self.checkpoint_folder}/{self.model_name}{self.SUFFIX_SEP}"
            f"{self.CHECKPOINT_EPOCH_KEY}{epoch}{self.SAVE_EXT}"
        )

    # -- save ----------------------------------------------------------------
    def save_checkpoint(
        self,
        params: Any,
        opt_state: Any,
        epoch: int,
        epoch_losses: Dict[str, float],
        best: bool = False,
    ) -> str:
        """Write one epoch checkpoint + update the meta file
        (snn.py:434-449).  ``params`` and ``opt_state`` are host trees
        (``train.trainer.host_snapshot``)."""
        save_path = self.checkpoint_path(epoch)
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        payload = {
            self.CHECKPOINT_EPOCH_KEY: int(epoch),
            self.CHECKPOINT_STATE_DICT_KEY: params,
            self.CHECKPOINT_OPTIMIZER_STATE_DICT_KEY: opt_state,
            self.CHECKPOINT_LOSS_KEY: {k: float(v)
                                       for k, v in epoch_losses.items()},
        }
        torch.save(payload, save_path)
        self.save_checkpoints_meta(self._new_checkpoint_meta(epoch, best))
        return save_path

    def _new_checkpoint_meta(self, epoch: int, best: bool) -> dict:
        save_path = self.checkpoint_path(epoch)
        new_info: dict = {self.CHECKPOINT_EPOCHS_KEY: {str(epoch): save_path}}
        if best:
            new_info[self.CHECKPOINT_BEST_KEY] = save_path
        return new_info

    def save_checkpoints_meta(self, new_info: dict) -> None:
        """Recursive-merge update of the meta JSON (snn.py:498-505)."""
        info: dict = {}
        if os.path.exists(self.checkpoints_meta_path):
            with open(self.checkpoints_meta_path) as f:
                info = json.load(f)
        mapping_update_recursively(info, new_info)
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        with open(self.checkpoints_meta_path, "w") as f:
            json.dump(info, f, indent=4)

    # -- load ----------------------------------------------------------------
    def get_save_path_from_checkpoints(
        self,
        checkpoints_meta: Dict[str, Union[str, Dict[Any, str]]],
        load_checkpoint_mode: LoadCheckpointMode = LoadCheckpointMode.BEST_EPOCH,
    ) -> str:
        """Resolve the file path for a load mode (snn.py:451-463)."""
        if load_checkpoint_mode == LoadCheckpointMode.BEST_EPOCH:
            return checkpoints_meta[self.CHECKPOINT_BEST_KEY]
        if load_checkpoint_mode == LoadCheckpointMode.LAST_EPOCH:
            epochs_dict = checkpoints_meta[self.CHECKPOINT_EPOCHS_KEY]
            last_epoch = max(int(e) for e in epochs_dict)
            return epochs_dict[str(last_epoch)]
        raise ValueError(f"Unknown load mode: {load_checkpoint_mode}")

    def load_checkpoint(
        self,
        load_checkpoint_mode: LoadCheckpointMode = LoadCheckpointMode.BEST_EPOCH,
    ) -> dict:
        """Load the raw checkpoint payload (snn.py:474-483).

        Raises FileNotFoundError if the meta file does not exist, matching
        the reference's resume-downgrade path (snn.py:308-317).
        """
        if not os.path.exists(self.checkpoints_meta_path):
            raise FileNotFoundError(self.checkpoints_meta_path)
        with open(self.checkpoints_meta_path) as f:
            info = json.load(f)
        return _read(self.get_save_path_from_checkpoints(
            info, load_checkpoint_mode))

    @property
    def best_merged_path(self) -> str:
        """The end-of-fit merged-best payload (``EnsembleTrainer`` with
        ``checkpoint_every > 1``): the per-seed best params stack plus
        the best-epoch vector, written once per fit."""
        return os.path.join(
            self.checkpoint_folder,
            f"{self.model_name}-best-merged{self.SAVE_EXT}")

    def save_best_merged(self, params, extra: Dict[str, Any]) -> None:
        payload = {self.CHECKPOINT_STATE_DICT_KEY: params, **extra}
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        torch.save(payload, self.best_merged_path)

    def load_best_merged(self) -> Union[dict, None]:
        if not os.path.exists(self.best_merged_path):
            return None
        return _read(self.best_merged_path)

    def load_checkpoint_at(self, epoch: int) -> dict:
        """Load one specific epoch's raw payload (used by the ensemble's
        per-seed BEST reconstruction on resume)."""
        path = self.checkpoint_path(epoch)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return _read(path)

    def restore(self, checkpoint: dict, params, optimizer):
        """Load a raw checkpoint payload into ``params`` (a ``{layer:
        {leaf: tensor}}`` tree, in place) and ``optimizer`` (a
        ``MaskedAdam``); returns both.

        Params must restore: another tree or shape raises ValueError.  An
        optimizer state of another structure (a changed optimizer) leaves
        ``optimizer`` as it is with a loud warning -- the model weights are
        the portable part of a checkpoint, torch's ``strict=False`` idiom."""
        saved = checkpoint[self.CHECKPOINT_STATE_DICT_KEY]
        copy_tree_(params, saved)
        try:
            optimizer.load_state_dict(
                checkpoint[self.CHECKPOINT_OPTIMIZER_STATE_DICT_KEY])
        except (KeyError, ValueError):
            logger.warning(
                "Checkpoint optimizer state does not match this trainer's "
                "optimizer structure (changed optimizer); restoring params "
                "only and keeping the current optimizer state."
            )
        return params, optimizer

    def get_checkpoints_loss_history(self) -> LossHistory:
        """Concat losses from every epoch checkpoint (snn.py:465-472)."""
        history = LossHistory()
        with open(self.checkpoints_meta_path) as f:
            meta = json.load(f)
        epochs = meta[self.CHECKPOINT_EPOCHS_KEY]
        # Sort by epoch NUMBER: meta preserves insertion order, and a
        # deferred best save (checkpoint_every=N) appends its epoch after
        # later ones.
        for key in sorted(epochs, key=int):
            history.concat(_read(epochs[key])[self.CHECKPOINT_LOSS_KEY])
        return history


def copy_tree_(params, saved) -> None:
    """Copy the host tree ``saved`` into the ``{layer: {leaf: tensor}}``
    tree ``params`` in place (dtypes and devices of ``params`` kept);
    raises ValueError on another structure or shape."""
    if set(params) != set(saved) or any(
            set(group) != set(saved[name]) for name, group in params.items()):
        raise ValueError("checkpoint params do not match this model's "
                         "layers and leaves")
    with torch.no_grad():
        for name, group in params.items():
            for leaf, t in group.items():
                src = saved[name][leaf]
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint {name}.{leaf} has shape "
                        f"{tuple(src.shape)}, the model {tuple(t.shape)}")
                t.copy_(src)
