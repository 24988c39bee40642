"""Multi-seed ensembles: S independent replicas trained and served together.

Port of the JAX package's parallel/ensemble.py.  The reference's sweep
trains seeds strictly one after another (training.py:151-201); here the
replicas of one architecture are a leading axis S on every parameter leaf,
every replica sees the same batches, and one step trains them all.  No
gradient crosses replicas: each replica's loss depends on its own leaves
only, so the gradient of the sum of the losses is every replica's own.

On the card a head-fusible config runs the replicas through the
whole-network head kernels: ``fused_replicas="stacked"`` takes ONE stacked
kernel pair for all of them (``fused_head_fwd_train_stacked`` +
``fused_head_bwd_stacked``, models/snn.py:forward_logits_pixels_stacked),
the default takes S unrolled single launches.  Both give the same bits.
The ensemble server (:meth:`EnsembleTrainer.serve`) answers each batch with
one ``fused_head_fwd_stacked`` launch and the seed-averaged softmax.

Meshes and seed sharding (``mesh``, ``shard_seeds``) are not ported yet
(ROADMAP.md, Queue 1 item 4), and ``fit(epoch_block=K)`` keeps the JAX
blocked fit's results (batch order, histories, best snapshots, checkpoint
files, early-stop epoch) through the per-epoch loop: the XLA dispatch
device it stands for has no counterpart here yet.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..data.datasets import ArrayDataLoader, EncodeConfig
from ..data.device_cache import DeviceDataCache, pad_rows
from ..models import snn as model_lib
from ..models.config import SNNConfig
from ..train.checkpoint import CheckpointManager, LoadCheckpointMode
from ..train.checkpoint import copy_tree_
from ..train.trainer import (
    ES_TOL,
    checkpoint_selected,
    encode_on_device,
    host_snapshot,
    make_optimizer,
    nll_loss,
)
from ..utils.history import LossHistory

__all__ = ["init_ensemble", "majority_vote", "replica", "EnsembleTrainer"]

logger = logging.getLogger(__name__)

Params = Dict[str, Dict[str, torch.Tensor]]
_FUSED_REPLICAS = (None, True, False, "unrolled", "stacked")


def init_ensemble(cfg: SNNConfig, seeds: Sequence[int], device="cuda"):
    """Stacked params: every leaf gains a leading ``n_seeds`` axis, and
    replica ``i`` is ``models.init`` at seed ``seeds[i]`` (one
    ``torch.Generator`` a seed)."""
    dev = resolve_device(device)
    per_seed = [model_lib.init(cfg, torch.Generator().manual_seed(int(s)),
                               device=dev) for s in seeds]
    return {name: {leaf: torch.stack([p[name][leaf] for p in per_seed])
                   for leaf in group}
            for name, group in per_seed[0].items()}


def replica(params: Params, i: int) -> Params:
    """Replica ``i`` of stacked params (views of the stacked leaves)."""
    return {name: {leaf: v[i] for leaf, v in group.items()}
            for name, group in params.items()}


def majority_vote(seed_preds: np.ndarray, n_classes: int) -> np.ndarray:
    """Hard majority vote over the seed axis: ``(n_seeds, B) -> (B,)``.
    Ties resolve to the lowest label (``np.bincount(...).argmax()``),
    deterministically."""
    seed_preds = np.asarray(seed_preds)
    return np.array([
        np.bincount(col, minlength=n_classes).argmax()
        for col in seed_preds.T
    ])


class EnsembleTrainer:
    """Trains N independent replicas per step.

    All replicas consume the same batches (the replicas differ in their
    init seed, as N sequential reference runs with different seeds would,
    modulo data order)."""

    def __init__(
        self,
        cfg: SNNConfig,
        seeds: Sequence[int],
        lr: float = 1e-3,
        weight_decay: float = 1e-5,
        max_grad_norm=None,
        mesh=None,
        checkpoint_folder: Optional[str] = None,
        model_name: str = "snn_ensemble",
        fused_replicas=None,
        shard_seeds: bool = False,
        grad_accum: Optional[int] = None,
        device="cuda",
    ):
        """``fused_replicas`` chooses how the replicas run (the JAX
        package's values):

        * ``None`` (default): S unrolled head-kernel launches on the card
          when the config head-fuses, the per-replica general path
          otherwise;
        * ``True`` / ``"unrolled"``: one ``forward_logits_pixels`` a
          replica (each takes its own dispatch);
        * ``"stacked"``: one stacked head kernel pair for all replicas;
          on a config it does not cover, a warning and the unrolled path;
        * ``False``: the per-replica general path (the raster encoded once
          and ``forward_logits`` a replica).

        ``max_grad_norm`` clips each replica by its own norm.
        ``grad_accum``: average the gradients of K consecutive batches per
        replica and apply one Adam update.  ``mesh`` and ``shard_seeds``
        are not ported yet and raise NotImplementedError."""
        if mesh is not None or shard_seeds:
            raise NotImplementedError(
                "EnsembleTrainer: meshes and seed sharding are not ported to "
                "PyTorch yet (ROADMAP.md, Queue 1 item 4)")
        if not (fused_replicas is None or isinstance(fused_replicas, bool)
                or fused_replicas in ("unrolled", "stacked")):
            raise ValueError(
                f"fused_replicas must be one of {_FUSED_REPLICAS}, got "
                f"{fused_replicas!r}")
        if len(seeds) < 1:
            raise ValueError("an ensemble needs at least one seed")
        self.cfg = cfg
        self.seeds = tuple(int(s) for s in seeds)
        self.device = resolve_device(device)
        self.fused_replicas = fused_replicas
        params = init_ensemble(cfg, self.seeds, self.device)
        labels = model_lib.param_labels(cfg, replica(params, 0))
        self.params: Params = {
            name: {leaf: v.requires_grad_(labels[name][leaf] == "weight")
                   for leaf, v in group.items()}
            for name, group in params.items()}
        self.optimizer = make_optimizer(
            self.params, labels, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, grad_accum=grad_accum, stacked=True)
        self.ckpt = (CheckpointManager(checkpoint_folder, model_name)
                     if checkpoint_folder else None)
        # Per-seed loss histories + per-seed best-val snapshot, filled by fit.
        self.histories: List[LossHistory] = [LossHistory()
                                             for _ in self.seeds]
        self.best_params: Optional[Params] = None
        self.best_val = np.full(len(self.seeds), np.inf)
        self.best_epoch = np.full(len(self.seeds), -1, dtype=int)
        self._modes: dict = {}
        # Small datasets live on the card; batches are gathered by index.
        self.device_data = DeviceDataCache()

    # -- the replicas' forward ----------------------------------------------
    def _mode(self, enc: EncodeConfig, training: bool) -> str:
        """``"stacked"``, ``"unrolled"`` or ``"loop"`` for this encoding."""
        key = (enc, training)
        if key in self._modes:
            return self._modes[key]
        cfg, dev, fr = self.cfg, self.device, self.fused_replicas
        if fr is None:
            fused = dev.type == "cuda" and model_lib.stacked_head_fusible(
                cfg, enc, dev, training)
            mode = "unrolled" if fused else "loop"
        elif fr is False:
            mode = "loop"
        elif fr == "stacked":
            mode = "stacked"
            if not model_lib.stacked_head_fusible(cfg, enc, dev, training):
                # No silent substitution: the flag exists for A/B runs.
                logger.warning(
                    "fused_replicas='stacked' requested but the config is "
                    "not stacked-head-fusible; falling back to the UNROLLED "
                    "path -- measurements are NOT the stacked variant.")
                mode = "unrolled"
        else:
            mode = "unrolled"
        self._modes[key] = mode
        return mode

    def _all_logits(self, params: Params, x: torch.Tensor,
                    enc: EncodeConfig, mode: str) -> torch.Tensor:
        """Every replica's logits ``(S, B, O)`` from pixels ``x``."""
        cfg, dev, n = self.cfg, self.device, len(self.seeds)
        if mode == "stacked":
            return model_lib.forward_logits_pixels_stacked(
                cfg, params, x, enc, device=dev)
        if mode == "unrolled":
            return torch.stack([
                model_lib.forward_logits_pixels(cfg, replica(params, i), x,
                                                enc, device=dev)
                for i in range(n)])
        inputs = encode_on_device(x, enc)  # encoded once, shared
        return torch.stack([
            model_lib.forward_logits(cfg, replica(params, i), inputs,
                                     device=dev)
            for i in range(n)])

    def _losses(self, logits, y, w) -> torch.Tensor:
        return torch.stack([nll_loss(logits[i], y, w)
                            for i in range(logits.shape[0])])

    def _enc(self, encode_config: Optional[EncodeConfig]) -> EncodeConfig:
        return encode_config or EncodeConfig(n_steps=self.cfg.int_time_steps)

    def _batch(self, x, y, w=None):
        dev = self.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, device=dev).to(torch.int64)
        w = (torch.ones(x.shape[0], dtype=torch.float32, device=dev)
             if w is None
             else torch.as_tensor(w, dtype=torch.float32, device=dev))
        return x, y, w

    # -- steps -------------------------------------------------------------
    def train_step(self, x, y, w=None,
                   encode_config: Optional[EncodeConfig] = None):
        """One optimizer step of every replica on one batch of pixels;
        returns the per-seed losses ``(S,)`` (on the device, not read)."""
        enc = self._enc(encode_config)
        x, y, w = self._batch(x, y, w)
        losses = self._losses(
            self._all_logits(self.params, x, enc, self._mode(enc, True)),
            y, w)
        opt = self.optimizer
        flat = torch.autograd.grad(losses.sum(), opt.tensors,
                                   allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (name, leaf), p, g in zip(opt.keys, opt.tensors, flat):
            grads.setdefault(name, {})[leaf] = (
                torch.zeros_like(p) if g is None else g)
        opt.step(grads)
        return losses.detach()

    @torch.no_grad()
    def eval_step(self, x, y, w=None,
                  encode_config: Optional[EncodeConfig] = None):
        """``(per-seed losses (S,), per-seed predictions (S, B))``."""
        enc = self._enc(encode_config)
        x, y, w = self._batch(x, y, w)
        logits = self._all_logits(self.params, x, enc,
                                  self._mode(enc, False))
        return self._losses(logits, y, w), logits.argmax(dim=-1)

    def _batches(self, loader: ArrayDataLoader):
        """One epoch of ``(x, y, w)`` device batches, each padded to the
        loader's batch size with weight-0 rows."""
        if self.device_data.fits(loader):
            yield from self.device_data.batches(loader, self.device)
            return
        for idx in loader.iter_indices():
            idx_p, w = pad_rows(np.asarray(idx), loader.batch_size)
            yield self._batch(loader.x[idx_p], loader.y[idx_p], w)

    def train_epoch(self, loader: ArrayDataLoader) -> np.ndarray:
        """One epoch over the loader; returns the mean loss per seed (one
        host read)."""
        enc = loader.encode_config
        losses = [self.train_step(xb, yb, wb, enc)
                  for xb, yb, wb in self._batches(loader)]
        if not losses:
            raise ValueError("train_epoch: the loader yielded no batch")
        return np.mean(torch.stack(losses).cpu().numpy(), axis=0)

    def eval_epoch(self, loader: ArrayDataLoader):
        """(per-seed mean loss, per-seed accuracy) over the loader (one host
        read)."""
        enc = loader.encode_config
        losses, correct, total = [], [], []
        for xb, yb, wb in self._batches(loader):
            batch_losses, preds = self.eval_step(xb, yb, wb, enc)
            losses.append(batch_losses)
            correct.append(((preds == yb[None]) * wb[None]).sum(dim=1))
            total.append(wb.sum())
        if not losses:
            raise ValueError("eval_epoch: the loader yielded no batch")
        correct_np = torch.stack(correct).cpu().numpy().astype(np.float64)
        n = float(torch.stack(total).sum())
        return (np.mean(torch.stack(losses).cpu().numpy(), axis=0),
                correct_np.sum(axis=0) / max(n, 1.0))

    def accuracies(self, loader: ArrayDataLoader) -> np.ndarray:
        """Per-seed accuracy over the loader."""
        return self.eval_epoch(loader)[1]

    # -- ensemble inference ------------------------------------------------
    # Soft voting ("mean_proba": argmax of the seed-averaged softmax) and
    # hard majority voting ("vote", ties to the lowest label).
    @torch.no_grad()
    def predict_logits(self, x,
                       encode_config: Optional[EncodeConfig] = None):
        """Per-seed logits ``(n_seeds, B, n_classes)`` on the device for raw
        pixel inputs."""
        enc = self._enc(encode_config)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self._all_logits(self.params, x, enc, self._mode(enc, False))

    def predict_proba(self, x, encode_config: Optional[EncodeConfig] = None,
                      reduce: Optional[str] = "mean"):
        """Class probabilities: the seed-averaged softmax ``(B, n_classes)``
        (``reduce="mean"``), or per-seed probabilities ``(n_seeds, B,
        n_classes)`` with ``reduce=None``; tensors on the device."""
        if reduce not in (None, "mean"):
            raise ValueError(f"unknown reduce {reduce!r}; use 'mean' or None")
        probas = torch.softmax(self.predict_logits(x, encode_config), dim=-1)
        return probas if reduce is None else probas.mean(dim=0)

    def predict(self, x, encode_config: Optional[EncodeConfig] = None,
                method: str = "mean_proba") -> np.ndarray:
        """Ensemble class predictions ``(B,)``: ``"mean_proba"`` the argmax
        of the seed-averaged softmax (soft voting, the default), ``"vote"``
        the per-seed argmax's majority, ties to the lowest label."""
        if method == "mean_proba":
            return self.predict_proba(x, encode_config).argmax(
                dim=-1).cpu().numpy()
        if method != "vote":
            raise ValueError(
                f"unknown method {method!r}; use 'mean_proba' or 'vote'")
        seed_preds = self.predict_logits(x, encode_config).argmax(
            dim=-1).cpu().numpy()
        return majority_vote(seed_preds, self.cfg.output_size)

    def ensemble_accuracy(self, loader: ArrayDataLoader,
                          method: str = "mean_proba") -> float:
        """Accuracy of the combined ensemble predictor over the loader."""
        correct, total = 0, 0
        for x, y in loader:
            pred = self.predict(x, loader.encode_config, method=method)
            correct += int(np.sum(pred == np.asarray(y)))
            total += len(np.asarray(y))
        return correct / max(total, 1)

    def serve(self, *, encode_config: Optional[EncodeConfig] = None,
              **server_kwargs):
        """An :class:`~..serve.InferenceServer` over the whole ensemble.

        Its per-batch forward is the soft-voting forward: every replica's
        logits (ONE ``fused_head_fwd_stacked`` launch where the config is
        stacked-head-fusible, one forward a replica elsewhere), softmaxed
        and averaged over the seeds on the device.  Each request's rows are
        the ensemble's mean class PROBABILITIES ``(B, n_classes)``, and
        ``classify`` argmaxes them as :meth:`predict` does.  The server
        copies the stacked params; call after ``load_best()`` to serve the
        per-seed best snapshots.  ``server_kwargs`` pass through
        (batch_size, max_delay_s, input_dtype, ...)."""
        from ..serve import InferenceServer

        cfg, dev = self.cfg, self.device
        enc = self._enc(encode_config)
        n_rep = len(self.seeds)
        use_stacked = model_lib.stacked_head_fusible(cfg, enc, dev)

        def soft_voting_forward(params, x):
            if use_stacked:
                logits = model_lib.forward_logits_pixels_stacked(
                    cfg, params, x, enc, device=dev)
            else:
                logits = torch.stack([
                    model_lib.forward_logits_pixels(
                        cfg, replica(params, i), x, enc, device=dev)
                    for i in range(n_rep)])
            return torch.softmax(logits, dim=-1).mean(dim=0)

        server_kwargs.setdefault("device", dev)
        return InferenceServer(cfg, self.params, encode_config=enc,
                               forward_fn=soft_voting_forward,
                               **server_kwargs)

    # -- fit -------------------------------------------------------------------
    def fit(
        self,
        train_dataloader: ArrayDataLoader,
        val_dataloader: ArrayDataLoader,
        nb_epochs: int = 15,
        load_checkpoint_mode: Optional[LoadCheckpointMode] = None,
        force_overwrite: bool = False,
        early_stopping: bool = False,
        early_stopping_patience: int = 5,
        verbose: bool = True,
        epoch_block: Optional[int] = None,
        checkpoint_every: int = 1,
    ) -> List[LossHistory]:
        """Train all replicas together with per-epoch train and validation
        phases, per-seed best-val snapshots and optional plateau early
        stopping (the ensemble counterpart of ``Trainer.fit``,
        snn.py:280-350).

        Per-seed best params are merged on the device each epoch;
        ``load_best()`` installs them (the stacked BEST_EPOCH reload,
        training.py:130).  Early stopping plateaus on the MEAN val loss
        across seeds (quirk Q6), including the under-full window: with one
        recorded epoch the diff is empty, so ``early_stopping=True`` stops
        after the first epoch, as in the reference and the JAX trainers.

        Resume (quirk Q5, snn.py:302-317): with ``load_checkpoint_mode=None``
        an existing checkpoint folder needs ``force_overwrite=True`` (then
        it is wiped); ``LAST_EPOCH``/``BEST_EPOCH`` restore the stacked
        params and optimizer, the per-seed histories and best snapshots,
        and a missing checkpoint downgrades to a warning.  For a resumed
        fit to equal a continuous one, hand it loaders whose shuffles have
        advanced as far (the loaders' generators are not checkpointed).

        ``checkpoint_every=N`` writes epoch files for every Nth and the
        final epoch only (the meta records every epoch) plus one merged-best
        payload at fit end.  ``epoch_block=K`` gives the JAX blocked fit's
        results through the per-epoch loop."""
        if epoch_block is not None and int(epoch_block) < 1:
            raise ValueError(f"epoch_block must be >= 1, got {epoch_block}")
        every = max(int(checkpoint_every), 1)
        start_epoch = self._prepare_resume(load_checkpoint_mode,
                                           force_overwrite, verbose)
        if start_epoch >= nb_epochs:
            return self.histories
        # Restored histories re-seed the early-stopping window.
        n_hist = min((len(h["val"]) for h in self.histories), default=0)
        mean_val_history: List[float] = [
            float(np.mean([h["val"][e] for h in self.histories]))
            for e in range(min(start_epoch, n_hist))
        ]
        for epoch in range(start_epoch, nb_epochs):
            train_losses = self.train_epoch(train_dataloader)
            val_losses, val_accs = self.eval_epoch(val_dataloader)
            for i, hist in enumerate(self.histories):
                hist.concat(dict(train=float(train_losses[i]),
                                 val=float(val_losses[i])))
            improved = val_losses < self.best_val
            self._update_best(improved, epoch)
            self.best_val = np.where(improved, val_losses, self.best_val)
            if self.ckpt is not None:
                if checkpoint_selected(epoch, nb_epochs, every):
                    self._save_checkpoint(epoch, train_losses, val_losses,
                                          improved)
                else:
                    self._write_meta(epoch, train_losses, val_losses)
            mean_val_history.append(float(np.mean(val_losses)))
            if verbose:
                logger.info(
                    "ensemble epoch %d: train_loss=%.5e val_loss=%.5e "
                    "val_acc=%.5f", epoch, np.mean(train_losses),
                    np.mean(val_losses), np.mean(val_accs))
            window = mean_val_history[-early_stopping_patience:]
            if early_stopping and bool(
                    np.all(np.abs(np.diff(window)) < ES_TOL)):
                if verbose:
                    logger.info("Early stopping stopped the ensemble at "
                                "epoch %d.", epoch)
                break
        if self.ckpt is not None and every > 1:
            self._write_best_merged()
        return self.histories

    def _write_best_merged(self) -> None:
        """The per-seed best stack as the merged-best payload that
        ``_reconstruct_best_params`` prefers (``checkpoint_every > 1``)."""
        if self.best_params is None:
            return
        self.ckpt.save_best_merged(
            host_snapshot(self.best_params),
            {"best_epoch_per_seed": [int(e) for e in self.best_epoch]})

    def _prepare_resume(self, load_checkpoint_mode, force_overwrite: bool,
                        verbose: bool) -> int:
        """Apply the Q5 overwrite/resume contract; returns the start
        epoch."""
        if self.ckpt is None:
            return 0
        if load_checkpoint_mode is None:
            if os.path.exists(self.ckpt.checkpoints_meta_path):
                if not force_overwrite:
                    raise AssertionError(
                        f"{self.ckpt.checkpoints_meta_path} already exists. "
                        "Set force_overwrite flag to True to overwrite "
                        "existing saves.")
                shutil.rmtree(self.ckpt.checkpoint_folder)
            return 0
        try:
            return self._restore_from_checkpoint(load_checkpoint_mode)
        except FileNotFoundError:
            if verbose:
                logger.warning("No such checkpoint. Fit from beginning.")
            return 0

    def _restore_from_checkpoint(self, mode: LoadCheckpointMode) -> int:
        """Restore the stacked params and optimizer, the per-seed histories
        and the per-seed best snapshots (from the epoch files that
        ``best_per_seed`` names, or the merged-best payload)."""
        checkpoint = self.ckpt.load_checkpoint(mode)
        with open(self.ckpt.checkpoints_meta_path) as f:
            meta = json.load(f)
        ens_meta = meta.get("ensemble", {})
        saved_seeds = ens_meta.get("seeds")
        if saved_seeds is not None and list(saved_seeds) != list(self.seeds):
            raise ValueError(
                f"Checkpoint was written for seeds {saved_seeds}, this "
                f"trainer has seeds {list(self.seeds)}")
        self.ckpt.restore(checkpoint, self.params, self.optimizer)
        start_epoch = int(checkpoint[self.ckpt.CHECKPOINT_EPOCH_KEY]) + 1
        self.histories = [LossHistory() for _ in self.seeds]
        for epoch_key in sorted(ens_meta.get("history", {}), key=int):
            # Entries at or after the resume epoch (an early-stopped fit
            # with checkpoint_every can record meta past the last params
            # file) would be trained again: drop them, index == epoch.
            if int(epoch_key) >= start_epoch:
                continue
            per_seed = ens_meta["history"][epoch_key]
            for i, hist in enumerate(self.histories):
                hist.concat(dict(train=per_seed["train"][i],
                                 val=per_seed["val"][i]))
        best_val = ens_meta.get("best_val_per_seed", {})
        best_epoch = meta.get("best_per_seed", {})
        self.best_val = np.array(
            [float(best_val.get(str(s), np.inf)) for s in self.seeds])
        self.best_epoch = np.array(
            [int(best_epoch.get(str(s), -1)) for s in self.seeds], dtype=int)
        self._reconstruct_best_params()
        return start_epoch

    def _snapshot(self) -> Params:
        """A detached device copy of the current params."""
        return {name: {leaf: v.detach().clone() for leaf, v in group.items()}
                for name, group in self.params.items()}

    def _reconstruct_best_params(self) -> None:
        """Rebuild the stacked per-seed BEST snapshot: the merged-best
        payload where its best epochs match the meta, else each distinct
        best epoch's (stacked) file, merging the seeds whose best it is."""
        if (self.best_epoch < 0).all():
            self.best_params = None
            return
        merged = self.ckpt.load_best_merged()
        if merged is not None and [
                int(e) for e in merged.get("best_epoch_per_seed", [])
        ] == [int(e) for e in self.best_epoch]:
            best = self._snapshot()
            copy_tree_(best, merged[self.ckpt.CHECKPOINT_STATE_DICT_KEY])
            self.best_params = best
            return
        best = self._snapshot()
        for e in sorted({int(x) for x in self.best_epoch if x >= 0}):
            try:
                payload = self.ckpt.load_checkpoint_at(e)
            except FileNotFoundError:
                logger.warning(
                    "Best-epoch checkpoint %d missing (checkpoint_every "
                    "skipped it and no up-to-date merged-best payload "
                    "exists -- interrupted fit?); the affected seeds keep "
                    "their current params as 'best'.", e)
                continue
            at_e = self._snapshot()
            copy_tree_(at_e, payload[self.ckpt.CHECKPOINT_STATE_DICT_KEY])
            self._merge(best, at_e, self.best_epoch == e)
        self.best_params = best

    def _merge(self, best: Params, cur: Params, mask: np.ndarray) -> None:
        """``best[s] = cur[s]`` for the seeds where ``mask``, in place."""
        m = torch.as_tensor(np.asarray(mask), device=self.device)
        with torch.no_grad():
            for name, group in best.items():
                for leaf, b in group.items():
                    c = cur[name][leaf].detach()
                    b.copy_(torch.where(
                        m.view((-1,) + (1,) * (c.dim() - 1)), c, b))

    def _update_best(self, improved: np.ndarray, epoch: int) -> None:
        """Merge the improved seeds' current params into the best
        snapshot."""
        if self.best_params is None:
            self.best_params = self._snapshot()
        else:
            self._merge(self.best_params, self.params, improved)
        self.best_epoch = np.where(improved, epoch, self.best_epoch)

    def load_best(self) -> None:
        """Install the per-seed best-val params (stacked BEST_EPOCH
        reload)."""
        if self.best_params is not None:
            copy_tree_(self.params, self.best_params)

    def _save_checkpoint(self, epoch, train_losses, val_losses,
                         improved) -> None:
        self.ckpt.save_checkpoint(
            host_snapshot(self.params),
            host_snapshot(self.optimizer.state_dict()),
            epoch,
            dict(train=float(np.mean(train_losses)),
                 val=float(np.mean(val_losses))),
            best=bool(np.any(improved)),
        )
        self._write_meta(epoch, train_losses, val_losses)

    def _write_meta(self, epoch, train_losses, val_losses) -> None:
        """The JSON-meta half of a checkpoint: per-seed losses of this epoch
        and the current best metadata, written for EVERY epoch (also those
        whose file ``checkpoint_every`` skips), so restored histories stay
        dense and the merged-best payload's epochs match the meta."""
        self.ckpt.save_checkpoints_meta({
            "best_per_seed": {
                str(s): int(e) for s, e in zip(self.seeds, self.best_epoch)
            },
            "ensemble": {
                "seeds": [int(s) for s in self.seeds],
                "best_val_per_seed": {
                    str(s): float(v)
                    for s, v in zip(self.seeds, self.best_val)
                    if np.isfinite(v)
                },
                "history": {
                    str(epoch): {
                        "train": [float(v) for v in train_losses],
                        "val": [float(v) for v in val_losses],
                    }
                },
            },
        })
