"""Functional SNN model: parameter init, simulation, logits.

Port of the JAX package's models/snn.py.  ``params`` is a
``{layer_name: {leaf: tensor}}`` dict in the JAX layout, so weights carry
across as plain copies (models/convert.py).

Two paths compute the logits:

* the whole-network head (ops/fused.py): single-hidden-layer LIF/ALIF
  classifiers with the max-over-time readout and on-device encoding run
  as one call -- the hand-written CUDA kernels on the card (inference;
  training forward and reverse-time backward when a parameter requires a
  gradient), their plain PyTorch versions on the CPU;
* everything else: :func:`apply`, a per-layer time loop (the reference's
  layer-then-time order, snn.py:209-214), then
  :func:`prediction_logits`.  On the card a config that gates off the
  kernel says so in the log, once per config.

The entry points take ``device`` ("cuda" by default); without CUDA they
raise unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch

from .._device import resolve_device
from ..ops.cells import (
    ALIFConfig,
    INIT_PARAM_FNS,
    INIT_STATE_FNS,
    LIFConfig,
    ReadoutConfig,
    STEP_FNS,
    masked_recurrent,
)
from ..ops.encoding import encode_spikes, pixels_to_firing_periods
from ..ops.fused import (
    KERNEL,
    KERNEL_BWD,
    KERNEL_TRAIN,
    fused_encode_ff_scan_head,
    fused_encode_ff_scan_head_counts,
    fused_encode_rec_scan_head,
    fused_encode_rec_scan_head_counts,
    fused_head_supported,
)
from ..ops.temporal import batchwise_temporal_filter, temporal_max
from .config import ReadoutMth, SNNConfig

__all__ = [
    "init",
    "init_state",
    "format_inputs",
    "apply",
    "apply_pixels",
    "prediction_logits",
    "forward_logits",
    "forward_logits_pixels",
    "forward_logits_counts_pixels",
    "explain_dispatch",
    "param_labels",
]

Params = Dict[str, Dict[str, torch.Tensor]]

logger = logging.getLogger(__name__)
_fallback_logged: set = set()


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _log_fused_fallback(kind: str, reason: str, _level=logging.INFO,
                        **shape) -> None:
    """Report, once per distinct config, that a CUDA kernel gated off and
    the model runs the plain PyTorch loop instead.  Config choices log at
    WARNING, shape gates at INFO."""
    key = (kind, reason, tuple(sorted(shape.items())))
    if key in _fallback_logged:
        return
    _fallback_logged.add(key)
    detail = ", ".join(f"{k}={v}" for k, v in sorted(shape.items()))
    logger.log(
        _level,
        "CUDA %s kernel unavailable (%s; %s): falling back to the plain "
        "PyTorch loop (same semantics, lower throughput).",
        kind, reason, detail,
    )


def _to(params: Params, device: torch.device) -> Params:
    return {n: {k: v.to(device) for k, v in g.items()}
            for n, g in params.items()}


def _needs_grad(params: Params) -> bool:
    """A backward may follow: grad mode is on and a leaf asks for one."""
    return torch.is_grad_enabled() and any(
        v.requires_grad for g in params.values() for v in g.values())


def init(cfg: SNNConfig, generator: torch.Generator,
         dtype=torch.float32, device="cuda") -> Params:
    """Initialize all layer parameters from ``generator``.

    Hidden weights ~ N(0, threshold^2), readout W ~ N(0, 1) with zero
    bias, learnable ALIF beta ~ N(0, threshold^2) (the reference's init
    quirk).  Draws happen on the generator's device, then move."""
    dev = resolve_device(device)
    return {
        name: INIT_PARAM_FNS[type(lcfg)](lcfg, generator, dtype, dev)
        for name, lcfg in cfg.layer_configs
    }


def init_state(cfg: SNNConfig, batch_size: int, dtype=torch.float32,
               device="cuda") -> Tuple:
    """Zero (v_rest for Izhikevich) initial state, one per layer."""
    dev = resolve_device(device)
    return tuple(
        INIT_STATE_FNS[type(lcfg)](lcfg, batch_size, dtype, dev)
        for _, lcfg in cfg.layer_configs
    )


def format_inputs(cfg: SNNConfig, inputs: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Shape inputs to ``(B, T, F)`` (snn.py:159-184): ``(B, F)`` repeats
    over ``int_time_steps``; shorter ``(B, T', F)`` zero-pads in time."""
    if inputs.dim() == 2:
        inputs = inputs[:, None, :].expand(
            inputs.shape[0], cfg.int_time_steps, inputs.shape[1])
    if inputs.dim() != 3:
        raise ValueError(
            "inputs must be (batch, features) or (batch, time, features); "
            f"got shape {tuple(inputs.shape)}"
        )
    t_diff = cfg.int_time_steps - inputs.shape[1]
    if t_diff < 0:
        raise ValueError(
            f"inputs have {inputs.shape[1]} time steps > int_time_steps="
            f"{cfg.int_time_steps}"
        )
    inputs = inputs.to(dtype)
    if t_diff > 0:
        pad = torch.zeros((inputs.shape[0], t_diff, inputs.shape[2]),
                          dtype=dtype, device=inputs.device)
        inputs = torch.cat([inputs, pad], dim=1)
    return inputs


def apply(cfg: SNNConfig, params: Params, inputs, *,
          return_hidden: bool = False,
          initial_state: Optional[Tuple] = None,
          return_spike_counts: bool = False, device="cuda"):
    """Simulate ``cfg.int_time_steps`` steps, one layer at a time.

    Each layer computes its input currents for all steps in one matmul,
    then loops over time.  Returns ``(outputs_trace (B, T, O),
    hidden_states)``; ``hidden_states`` is ``{layer: tuple of (B, T,
    width)}`` when ``return_hidden``, else None.  ``return_spike_counts``
    appends ``{layer: (B, width) float32}``, the per-sample per-neuron
    spike counts ``sum_t z_t`` of the LIF/ALIF layers (the reference's
    ``isinstance(layer, LIFLayer)`` filter, snn.py:268: no Izhikevich, no
    readout)."""
    dev = resolve_device(device)
    compute_dtype = _dtype(cfg.compute_dtype)
    matmul_dtype = _dtype(cfg.matmul_dtype_eff)
    x = format_inputs(cfg, torch.as_tensor(inputs, device=dev), compute_dtype)
    batch = x.shape[0]
    cparams = {n: {k: v.to(dev, compute_dtype) for k, v in g.items()}
               for n, g in params.items()}
    states = (initial_state if initial_state is not None
              else init_state(cfg, batch, compute_dtype, device=dev))
    hidden = {} if return_hidden else None
    counts = {} if return_spike_counts else None

    def mm(a, w):
        """a @ w with matmul_dtype operands accumulating in compute_dtype
        (products of bf16 values are exact in float32)."""
        if matmul_dtype == a.dtype == w.dtype:
            return a @ w
        return (a.to(matmul_dtype).to(torch.float32)
                @ w.to(matmul_dtype).to(torch.float32)).to(compute_dtype)

    x_tm = None  # layer outputs are time-major (T, B, width)
    for idx, (name, lcfg) in enumerate(cfg.layer_configs):
        lparams = cparams[name]
        step_fn = STEP_FNS[type(lcfg)]
        w_rec_eff = masked_recurrent(lcfg, lparams)
        if w_rec_eff is not None and w_rec_eff.dtype != matmul_dtype:
            w_rec_eff = w_rec_eff.to(matmul_dtype)
        currents = (mm(x, lparams["w_in"]).transpose(0, 1) if x_tm is None
                    else mm(x_tm, lparams["w_in"]))
        state = states[idx]
        outs, trace = [], []
        for t in range(currents.shape[0]):
            out, state = step_fn(lcfg, lparams, state, currents[t],
                                 w_rec_eff=w_rec_eff,
                                 precomputed_input_current=True)
            outs.append(out)
            if return_hidden:
                trace.append(state)
        if return_hidden:
            hidden[name] = tuple(
                torch.stack(leaf, dim=1).to(torch.float32)
                for leaf in zip(*trace)
            )
        x_tm = torch.stack(outs)
        if counts is not None and type(lcfg) in (LIFConfig, ALIFConfig):
            counts[name] = x_tm.to(torch.float32).sum(0)
    trace = x_tm.transpose(0, 1).to(torch.float32)
    if return_spike_counts:
        return trace, hidden, counts
    return trace, hidden


def apply_pixels(cfg: SNNConfig, params: Params, pixels, enc, *,
                 return_hidden: bool = False,
                 return_spike_counts: bool = False, device="cuda"):
    """Simulate from raw pixels ``(B, F)``, encoding on the device
    (``enc`` is a ``data.datasets.EncodeConfig``)."""
    dev = resolve_device(device)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    inputs = pixels if not enc.as_timeseries else encode_spikes(
        pixels, n_steps=enc.n_steps, use_periods=enc.use_periods,
        tau=enc.tau, thr=enc.thr, epsilon=enc.epsilon)
    return apply(cfg, params, inputs, return_hidden=return_hidden,
                 return_spike_counts=return_spike_counts, device=dev)


def _head_fusible(cfg: SNNConfig, enc, device: torch.device,
                  training: bool = False) -> bool:
    """Whole-network head available: one LIF/ALIF hidden layer, the
    max-over-time readout, on-device encoding at ``int_time_steps`` and
    float32 compute; with ``training`` the backward kernel must cover the
    shape too.  On the card every gate a config hits is logged."""
    on_card = device.type == "cuda"
    if not cfg.use_kernels:
        return False
    if _dtype(cfg.compute_dtype) != torch.float32:
        if on_card:
            _log_fused_fallback(
                "whole-network head", "compute_dtype != float32; for the "
                "bf16 recipe keep compute_dtype='float32' and set "
                "matmul_dtype='bfloat16'", _level=logging.WARNING,
                compute_dtype=cfg.compute_dtype)
        return False
    if not (enc.as_timeseries and enc.n_steps == cfg.int_time_steps):
        return False
    if cfg.readout_mth != ReadoutMth.RNN:
        return False
    layer_cfgs = cfg.layer_configs
    first_cfg, last_cfg = layer_cfgs[0][1], layer_cfgs[-1][1]
    if len(layer_cfgs) != 2 or type(first_cfg) not in (LIFConfig, ALIFConfig):
        # The JAX package fuses these too (deep, two-layer and Izhikevich
        # heads); their kernels are later slices of the port.
        if on_card and type(last_cfg) is ReadoutConfig and len(layer_cfgs) > 1:
            _log_fused_fallback(
                "whole-network head", "this network's head kernel is not "
                "ported yet", _level=logging.WARNING,
                n_layers=len(layer_cfgs), layer=type(first_cfg).__name__)
        return False
    ok = fused_head_supported(
        cfg.int_time_steps, cfg.input_size, first_cfg.output_size,
        last_cfg.output_size, recurrent=first_cfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training, use_periods=enc.use_periods,
    )
    if not ok and on_card:
        _log_fused_fallback(
            "whole-network head", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, n_features=cfg.input_size,
            hidden=first_cfg.output_size, n_out=last_cfg.output_size,
            matmul_dtype=cfg.matmul_dtype_eff, training=training)
    return ok


def _lif_alif_head_call(cfg, first_cfg, last_cfg, lparams0, latencies, w0,
                        w_out, b_out, enc, counts=False):
    """The LIF/ALIF head call: beta from params under ``learn_beta``, else
    ``cfg.beta``; LIF passes 0.  ``W_rec`` is eye-masked before the cast
    to the matmul dtype.  ``counts=True`` takes the ``_counts`` variants
    and returns ``(logits, spike_counts (B, H))``."""
    matmul_dtype = _dtype(cfg.matmul_dtype_eff)
    alif = type(first_cfg) is ALIFConfig
    beta = ((lparams0["beta"] if first_cfg.learn_beta else first_cfg.beta)
            if alif else 0.0)
    rho = first_cfg.rho if alif else 0.0
    common = (cfg.int_time_steps, enc.use_periods, alif, first_cfg.alpha,
              rho, first_cfg.threshold, first_cfg.gamma, last_cfg.kappa,
              first_cfg.spike_func)
    w_rec_eff = masked_recurrent(first_cfg, lparams0)
    if w_rec_eff is not None:
        w_rec_eff = w_rec_eff.to(matmul_dtype).contiguous()
        fn = (fused_encode_rec_scan_head_counts if counts
              else fused_encode_rec_scan_head)
        return fn(latencies, w0, w_rec_eff, beta, w_out, b_out, *common)
    fn = (fused_encode_ff_scan_head_counts if counts
          else fused_encode_ff_scan_head)
    return fn(latencies, w0, beta, w_out, b_out, *common)


def _head_forward(cfg: SNNConfig, params: Params, pixels, enc,
                  counts: bool):
    """The head-fusible branch of the two ``forward_logits_*_pixels``:
    latencies on the device, weights cast to the matmul dtype (the casts
    carry the gradient back to the float32 leaves)."""
    (first_name, first_cfg), (last_name, last_cfg) = cfg.layer_configs
    latencies = pixels_to_firing_periods(
        pixels, t_max=float(cfg.int_time_steps), tau=enc.tau, thr=enc.thr,
        epsilon=enc.epsilon,
    ).contiguous()
    matmul_dtype = _dtype(cfg.matmul_dtype_eff)
    lparams0 = params[first_name]
    w0 = lparams0["w_in"].to(matmul_dtype).contiguous()
    w_out = params[last_name]["w_in"].to(matmul_dtype).contiguous()
    b_out = params[last_name]["b"].to(torch.float32).contiguous()
    out = _lif_alif_head_call(cfg, first_cfg, last_cfg, lparams0, latencies,
                              w0, w_out, b_out, enc, counts=counts)
    if counts:
        return out[0], {first_name: out[1]}
    return out


def forward_logits_pixels(cfg: SNNConfig, params: Params, pixels, enc, *,
                          device="cuda") -> torch.Tensor:
    """Raw pixels ``(B, F)`` -> class logits ``(B, O)``, encoding inside;
    differentiable with respect to ``params`` on both paths.

    Head-fusible configs run the whole network as one head call; the rest
    compose :func:`apply_pixels` with :func:`prediction_logits`."""
    dev = resolve_device(device)
    params = _to(params, dev)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    if not _head_fusible(cfg, enc, dev, _needs_grad(params)):
        trace, _ = apply_pixels(cfg, params, pixels, enc, device=dev)
        return prediction_logits(cfg, trace)
    return _head_forward(cfg, params, pixels, enc, counts=False)


def forward_logits_counts_pixels(cfg: SNNConfig, params: Params, pixels, enc,
                                 *, device="cuda"):
    """Raw pixels ``(B, F)`` -> ``(logits, spike_counts)``, encoding
    inside.

    ``spike_counts`` is ``{layer: (B, width) float32}`` for the LIF/ALIF
    layers: all the spike regularizers (train/losses.py) need, without
    the ``(B, T, H)`` hidden traces.  Head-fusible configs keep the
    whole-network head (its ``_counts`` variants); the rest run
    :func:`apply_pixels` with ``return_spike_counts=True``."""
    dev = resolve_device(device)
    params = _to(params, dev)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    if _head_fusible(cfg, enc, dev, _needs_grad(params)):
        return _head_forward(cfg, params, pixels, enc, counts=True)
    trace, _, counts = apply_pixels(cfg, params, pixels, enc,
                                    return_spike_counts=True, device=dev)
    return prediction_logits(cfg, trace), counts


def prediction_logits(cfg: SNNConfig, outputs_trace: torch.Tensor):
    """Readout trace ``(B, T, O)`` -> logits: max over time (snn.py:228)
    or, with ``ReadoutMth.TEMPORAL_FILTER``, the decayed sum (snn.py:229)."""
    if cfg.readout_mth == ReadoutMth.TEMPORAL_FILTER:
        return batchwise_temporal_filter(outputs_trace,
                                         cfg.readout_filter_decay)
    return temporal_max(outputs_trace, time_axis=1)


def forward_logits(cfg: SNNConfig, params: Params, inputs, *,
                   device="cuda") -> torch.Tensor:
    """Simulate and reduce to logits in one call."""
    trace, _ = apply(cfg, params, inputs, device=device)
    return prediction_logits(cfg, trace)


def explain_dispatch(cfg: SNNConfig, enc=None, device="cuda",
                     training: bool = False) -> list:
    """Which implementation :func:`forward_logits_pixels` (with ``enc``)
    or :func:`apply` runs for each layer, and why: a list of ``{"layer",
    "path", "reason"}`` dicts.  Paths: ``cuda:fused_head_fwd`` (the
    inference kernel), ``cuda:fused_head_fwd_train+fused_head_bwd`` (the
    pair a ``training`` step launches), ``torch:fused_head_reference``
    (their plain versions, on the CPU) and ``torch:loop``.  It fires the
    same fallback logs the real dispatch would."""
    dev = resolve_device(device)
    names = tuple(name for name, _ in cfg.layer_configs)
    if enc is not None and _head_fusible(cfg, enc, dev, training):
        on_card = dev.type == "cuda"
        kernels = f"{KERNEL_TRAIN}+{KERNEL_BWD}" if training else KERNEL
        return [{
            "layer": names,
            "path": f"cuda:{kernels}" if on_card
            else "torch:fused_head_reference",
            "reason": "single-hidden-layer classifier with max-over-time "
                      "readout: encode + scan + readout + max in one call"
                      + (", reverse-time BPTT in another" if training else "")
                      + ("" if on_card else " (plain version on the CPU)"),
        }]
    if not cfg.use_kernels:
        reason = "use_kernels=False"
    elif enc is None:
        reason = "no encoding config: apply() has no kernel in this port"
    else:
        reason = "no CUDA kernel of this port covers this config"
    return [{"layer": name, "path": "torch:loop", "reason": reason}
            for name in names]


def param_labels(cfg: SNNConfig, params: Params) -> Dict[str, Dict[str, str]]:
    """Label every leaf for the optimizer: matmul weights and biases are
    ``"weight"``, a learnable ALIF beta is ``"beta"``.  Beta's gradient is
    dead (it enters only through the threshold), and the reference's Adam
    skips parameters without a gradient, so beta stays out of both the
    update and the L2 decay."""
    return {
        name: {leaf: ("beta" if leaf == "beta" else "weight")
               for leaf in group}
        for name, group in params.items()
    }
