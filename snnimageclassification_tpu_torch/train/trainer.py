"""Training step, masked Adam and a minimal trainer.

Port of the core of the JAX package's train/trainer.py.  One step is:
pixels -> on-device latencies -> the whole-network head in training mode
(``fused_head_fwd_train``) -> NLL loss -> the head's reverse-time backward
(``fused_head_bwd``) -> Adam with L2.  Deeper configs run one forward and
one backward kernel a hidden layer (``fused_layer0_fwd/bwd``,
``fused_mid_fwd/bwd``); layers no kernel covers run the plain time loop
under PyTorch autograd.

Optimizer parity: the reference uses ``torch.optim.Adam(lr=1e-3,
weight_decay=1e-5)`` (snn.py:298-299): L2 is added to the gradient before
the Adam moments, not decoupled.  A learnable ALIF beta has a dead
gradient (it enters only through the threshold), and the reference's Adam
skips parameters without one, so beta is kept out of the update and out
of the decay and stays bitwise what it was.

Loss parity: ``nn.NLLLoss`` on the log-softmax of the max-over-time
logits (snn.py:296, 250-258, 228), mean reduction.

Not here yet: checkpoints and resume, validation, early stopping, LR
schedules, several epochs per dispatch, meshes and the parallel
strategies.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from .._device import resolve_device
from ..data.datasets import EncodeConfig
from ..models import snn as model_lib
from ..models.config import SNNConfig

__all__ = ["Trainer", "MaskedAdam", "make_optimizer", "nll_loss",
           "default_criterion"]

Params = Dict[str, Dict[str, torch.Tensor]]


def nll_loss(logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL of log-softmax(logits), the reference's default criterion
    (snn.py:296-297 with snn.py:258).

    ``weights`` (0/1 per sample) keeps the mean exact when a batch is
    padded: ``sum(w * nll) / max(sum(w), 1)``."""
    per_sample = torch.nn.functional.cross_entropy(
        logits, labels.to(torch.int64), reduction="none")
    if weights is None:
        return per_sample.mean()
    return (per_sample * weights).sum() / torch.clamp(weights.sum(), min=1.0)


default_criterion = nll_loss


class MaskedAdam:
    """``torch.optim.Adam(lr, betas, eps, weight_decay)`` over the leaves
    labelled ``"weight"``; every other leaf (a learnable beta) is never
    touched.  ``step`` takes the gradients as a ``{layer: {leaf: tensor}}``
    dict (missing or None entries of masked leaves are fine).

    ``max_grad_norm`` scales the weights' gradients to that global norm
    before the decay and the moments.  ``grad_accum=K`` averages the
    gradients of K consecutive ``step`` calls and applies one update on
    the K-th; with equal micro-batch sizes that is the K-times-larger
    batch."""

    def __init__(self, params: Params, param_labels, lr: float = 1e-3,
                 weight_decay: float = 1e-5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None,
                 grad_accum: Optional[int] = None):
        self.keys = [(name, leaf) for name, group in params.items()
                     for leaf in group
                     if param_labels[name][leaf] == "weight"]
        self.tensors = [params[name][leaf] for name, leaf in self.keys]
        self.adam = torch.optim.Adam(self.tensors, lr=lr, betas=(b1, b2),
                                     eps=eps, weight_decay=weight_decay)
        self.max_grad_norm = (None if max_grad_norm is None
                              else float(max_grad_norm))
        self.grad_accum = (int(grad_accum)
                           if grad_accum is not None and int(grad_accum) > 1
                           else 1)
        self._sum: Optional[List[torch.Tensor]] = None
        self._micro = 0

    def step(self, grads) -> bool:
        """Take one gradient; returns whether the parameters moved."""
        g = [grads[name][leaf].detach().to(p.dtype)
             for (name, leaf), p in zip(self.keys, self.tensors)]
        if self.grad_accum > 1:
            self._sum = g if self._sum is None else [
                a + b for a, b in zip(self._sum, g)]
            self._micro += 1
            if self._micro < self.grad_accum:
                return False
            g = [a / self.grad_accum for a in self._sum]
            self._sum, self._micro = None, 0
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum((x.float() ** 2).sum() for x in g))
            scale = self.max_grad_norm / torch.clamp(
                norm, min=self.max_grad_norm)
            g = [x * scale for x in g]
        for p, x in zip(self.tensors, g):
            p.grad = x
        self.adam.step()
        for p in self.tensors:
            p.grad = None
        return True


def make_optimizer(params: Params, param_labels, lr: float = 1e-3,
                   weight_decay: float = 1e-5, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   max_grad_norm: Optional[float] = None,
                   grad_accum: Optional[int] = None) -> MaskedAdam:
    """Adam + L2 as ``torch.optim.Adam(lr, weight_decay)`` (snn.py:299)
    over ``params``, with the dead-gradient leaves (label ``"beta"``)
    frozen.  ``max_grad_norm`` and ``grad_accum`` are stability and memory
    knobs beyond the reference; their defaults reproduce it."""
    return MaskedAdam(params, param_labels, lr=lr, weight_decay=weight_decay,
                      b1=b1, b2=b2, eps=eps, max_grad_norm=max_grad_norm,
                      grad_accum=grad_accum)


class Trainer:
    """Owns the parameters and the optimizer and runs training and
    evaluation steps on ``device``.

    ``params``: a ``{layer: {leaf: tensor}}`` dict (copied), else drawn
    from ``seed``.  ``criterion(logits, labels, weights)`` defaults to
    :func:`nll_loss`.  ``reg_fn``: an optional spike regularizer
    (train/losses.py).  One with ``from_counts`` (``L1TotalSpikeCount``,
    ``L2SpikesPerNeuron``) trains on per-neuron spike counts and keeps the
    whole-network head; any other callable gets the hidden traces, which
    only the time loop returns."""

    def __init__(self, cfg: SNNConfig, *, params: Optional[Params] = None,
                 seed: int = 0, criterion: Optional[Callable] = None,
                 reg_fn: Optional[Callable] = None, lr: float = 1e-3,
                 weight_decay: float = 1e-5,
                 max_grad_norm: Optional[float] = None,
                 grad_accum: Optional[int] = None,
                 encode_config: Optional[EncodeConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = model_lib.init(
                cfg, torch.Generator().manual_seed(seed), device=self.device)
        labels = model_lib.param_labels(cfg, params)
        self.params: Params = {
            name: {leaf: v.detach().to(self.device).clone().requires_grad_(
                labels[name][leaf] == "weight") for leaf, v in group.items()}
            for name, group in params.items()}
        self.criterion = criterion or default_criterion
        self.reg_fn = reg_fn
        self.enc = encode_config or EncodeConfig(n_steps=cfg.int_time_steps)
        self.optimizer = make_optimizer(
            self.params, labels, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, grad_accum=grad_accum)

    # -- the step ----------------------------------------------------------
    def _batch(self, x, y, w=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device).to(torch.int64)
        w = (torch.ones(x.shape[0], dtype=torch.float32, device=self.device)
             if w is None
             else torch.as_tensor(w, dtype=torch.float32, device=self.device))
        return x, y, w

    def _loss(self, x, y, w):
        """``(loss, logits)`` by one of three forwards (the JAX trainer's
        ``loss_fn``): counts for a count-based regularizer, hidden traces
        for any other, else logits alone."""
        cfg, enc, dev = self.cfg, self.enc, self.device
        reg_fn = self.reg_fn
        if reg_fn is not None and hasattr(reg_fn, "from_counts"):
            logits, counts = model_lib.forward_logits_counts_pixels(
                cfg, self.params, x, enc, device=dev)
            return (self.criterion(logits, y, w)
                    + reg_fn.from_counts(counts, w), logits)
        if reg_fn is not None:
            trace, hidden = model_lib.apply_pixels(
                cfg, self.params, x, enc, return_hidden=True, device=dev)
            logits = model_lib.prediction_logits(cfg, trace)
            # Weight-0 padding rows must add no spikes to the regularizer.
            hidden = {
                name: tuple(t * w.reshape((-1,) + (1,) * (t.dim() - 1))
                            for t in traces)
                for name, traces in hidden.items()}
            return self.criterion(logits, y, w) + reg_fn(hidden), logits
        logits = model_lib.forward_logits_pixels(cfg, self.params, x, enc,
                                                 device=dev)
        return self.criterion(logits, y, w), logits

    def loss_and_grads(self, x, y, w=None):
        """``(loss, {layer: {leaf: gradient}})`` over the trained leaves,
        without touching the parameters."""
        x, y, w = self._batch(x, y, w)
        loss, _ = self._loss(x, y, w)
        opt = self.optimizer
        flat = torch.autograd.grad(loss, opt.tensors, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (name, leaf), p, g in zip(opt.keys, opt.tensors, flat):
            grads.setdefault(name, {})[leaf] = (
                torch.zeros_like(p) if g is None else g)
        return loss.detach(), grads

    def train_step(self, x, y, w=None) -> torch.Tensor:
        """One optimizer step on a batch of pixels ``(B, F)``, labels and
        optional 0/1 sample weights; returns the loss (a 0-d tensor on the
        device, not yet read by the host)."""
        loss, grads = self.loss_and_grads(x, y, w)
        self.optimizer.step(grads)
        return loss

    @torch.no_grad()
    def eval_step(self, x, y, w=None):
        """``(loss, predicted classes (B,))`` without a gradient."""
        x, y, w = self._batch(x, y, w)
        loss, logits = self._loss(x, y, w)
        return loss, logits.argmax(dim=-1)

    # -- loops -------------------------------------------------------------
    def fit(self, loader: Iterable, nb_epochs: int = 15) -> List[float]:
        """A bare epoch loop over ``loader`` (an iterable of ``(x, y)`` or
        ``(x, y, w)`` batches that can be walked once per epoch); returns
        the mean training loss of each epoch.  The host reads the losses
        once per epoch."""
        history = []
        for _ in range(nb_epochs):
            losses = [self.train_step(*batch) for batch in loader]
            if not losses:
                raise ValueError("fit: the loader yielded no batch")
            history.append(float(torch.stack(losses).mean()))
        return history

    @torch.no_grad()
    def predict_logits(self, x,
                       encode_config: Optional[EncodeConfig] = None):
        """Pixels ``(B, F)`` -> logits ``(B, O)`` on the device."""
        enc = encode_config or self.enc
        return model_lib.forward_logits_pixels(self.cfg, self.params, x, enc,
                                               device=self.device)

    def compute_classification_accuracy(self, loader: Iterable) -> float:
        """Per-sample mean accuracy over a loader (snn.py:507-525); one
        host read at the end."""
        correct, total = [], []
        for batch in loader:
            x, y, w = self._batch(*batch)
            _, preds = self.eval_step(x, y, w)
            correct.append(((preds == y) * w).sum())
            total.append(w.sum())
        if not correct:
            return 0.0
        n_correct = float(torch.stack(correct).sum())
        return round(n_correct) / max(round(float(torch.stack(total).sum())),
                                      1)
