"""Functional SNN model: parameter init, simulation, logits.

Port of the JAX package's models/snn.py.  ``params`` is a
``{layer_name: {leaf: tensor}}`` dict in the JAX layout, so weights carry
across as plain copies (models/convert.py).

Three paths compute the logits:

* the whole-network head (ops/fused.py, ops/fused_izh.py for
  Izhikevich): single-hidden-layer classifiers with the max-over-time
  readout and on-device encoding run as one call -- the hand-written CUDA
  kernels on the card (inference; training forward and reverse-time
  backward when a parameter requires a gradient), their plain PyTorch
  versions on the CPU;
* the two-layer pair (ops/fused2.py): exactly two LIF/ALIF hidden layers
  with one scalar set, the max-over-time readout and on-device encoding run
  as one call, the hand-written CUDA kernel pair on the card, its plain
  PyTorch versions on the CPU;
* the deep dispatch, for two or more hidden layers: layer 0 as one
  encode + scan call (ops/fused.py ``fused_encode_{rec,ff}_scan``,
  ops/fused_izh.py ``fused_encode_izh_scan``), each further LIF/ALIF layer
  as one mid call, and a last LIF/ALIF hidden layer with the readout and
  the max over time as one mid-head call (ops/fused_mid.py); an
  Izhikevich layer past the first scans its ``z_in @ W_in`` currents in one
  call (ops/izh.py ``izh_scan``); a layer no kernel covers (a shape past
  the limits) takes the unfused tier or the loop below in its place;
* the unfused tier, for layers too wide for those kernels' shared memory
  and for currents that come from a product (spike rasters, constant-pixel
  input, an encoding shorter than the simulation): a first layer's
  currents from the latencies in one call (ops/encode.py
  ``encoded_input_matmul``) or, from a raster, in one ``torch.matmul``, a
  later layer's in one ``torch.matmul``, then the layer's scan over them in
  one call (ops/rec_scan.py ``rec_{alif,lif}_scan`` for a recurrent
  LIF/ALIF layer, ops/scan.py ``{alif,lif}_scan`` for a feedforward one;
  Izhikevich: ``izh_scan``);
* stacked replicas (an ensemble of seeds, parallel/ensemble.py): a
  head-fusible config runs every replica's whole network in one stacked
  head call on one batch (:func:`forward_logits_pixels_stacked`);
* everything else: :func:`apply`, a per-layer time loop (the reference's
  layer-then-time order, snn.py:209-214), then
  :func:`prediction_logits`; the readout always loops.  On the card a
  config that gates off a kernel says so in the log, once per config.

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
    IzhikevichConfig,
    LIFConfig,
    ReadoutConfig,
    STEP_FNS,
    masked_recurrent,
)
from ..ops.encode import encode_matmul_supported, encoded_input_matmul
from ..ops.encoding import encode_spikes, pixels_to_firing_periods
from ..ops.fused import (
    KERNEL,
    KERNEL_2,
    KERNEL_2_BWD,
    KERNEL_2_TRAIN,
    KERNEL_BWD,
    KERNEL_BWD_STACKED,
    KERNEL_ENC,
    KERNEL_ENC_BWD,
    KERNEL_IZH,
    KERNEL_IZH_BWD,
    KERNEL_IZH_BWD_STACKED,
    KERNEL_IZH_L0,
    KERNEL_IZH_L0_BWD,
    KERNEL_IZH_SCAN,
    KERNEL_IZH_SCAN_BWD,
    KERNEL_IZH_STACKED,
    KERNEL_IZH_TRAIN,
    KERNEL_IZH_TRAIN_STACKED,
    KERNEL_L0,
    KERNEL_L0_BWD,
    KERNEL_MID,
    KERNEL_MID_BWD,
    KERNEL_REC,
    KERNEL_REC_BWD,
    KERNEL_REC_TRAIN,
    KERNEL_SCAN,
    KERNEL_SCAN_BWD,
    KERNEL_SCAN_TRAIN,
    KERNEL_STACKED,
    KERNEL_TRAIN,
    KERNEL_TRAIN_STACKED,
    fused_encode_ff_scan,
    fused_encode_ff_scan_head,
    fused_encode_ff_scan_head_counts,
    fused_encode_rec_scan,
    fused_encode_rec_scan_head,
    fused_encode_rec_scan_head_counts,
    fused_head_supported,
    fused_supported,
    gwin_copied_stage,
    head_bodies,
    layer0_bodies,
)
from ..ops.fused2 import (
    fused2_bodies,
    fused2_ff_head,
    fused2_ff_head_counts,
    fused2_head_supported,
    fused2_rec_head,
    fused2_rec_head_counts,
)
from ..ops.fused_izh import (
    fused_encode_izh_scan,
    fused_encode_izh_scan_head,
    fused_izh_head_supported,
    fused_izh_supported,
)
from ..ops.fused_izh import head_bodies as izh_head_bodies
from ..ops.fused_izh import layer0_bodies as izh_layer0_bodies
from ..ops.fused_mid import (
    fused_mid_ff_scan,
    fused_mid_ff_scan_head,
    fused_mid_ff_scan_head_counts,
    fused_mid_head_supported,
    fused_mid_rec_scan,
    fused_mid_rec_scan_head,
    fused_mid_rec_scan_head_counts,
    fused_mid_supported,
    mid_bodies,
)
from ..ops.izh import (
    izh_kernel_params,
    izh_scan,
    izh_scan_supported,
    scan_bodies as izh_scan_bodies,
)
from ..ops.rec_scan import (
    rec_alif_scan,
    rec_bodies,
    rec_lif_scan,
    rec_scan_supported,
)
from ..ops.scan import alif_scan, lif_scan, scan_supported
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
    "stacked_head_fusible",
    "forward_logits_pixels_stacked",
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
          first_layer_output: Optional[torch.Tensor] = None,
          first_layer_currents: Optional[torch.Tensor] = None,
          return_spike_counts: bool = False, _upto: Optional[int] = None,
          device="cuda"):
    """Simulate ``cfg.int_time_steps`` steps, one layer at a time.

    A LIF/ALIF layer past the first runs as one mid call (input product
    and scan together, ops/fused_mid.py) unless hidden traces or an
    initial state are asked for; every other layer computes its input
    currents for all steps in one matmul, then scans them in one call
    (:func:`_layer_scan`: a LIF/ALIF or an Izhikevich layer, on the same
    conditions) or loops over time (the readout always does).
    ``first_layer_output`` is layer 0's time-major spike trace ``(T, B,
    H0)`` computed upstream, ``first_layer_currents`` its time-major input
    currents ``(T, B, H0)`` (``inputs`` is then ignored).  Returns
    ``(outputs_trace (B, T, O), hidden_states)``; ``hidden_states`` is
    ``{layer: tuple of (B, T, width)}`` when ``return_hidden``, else None.
    ``return_spike_counts`` appends ``{layer: (B, width) float32}``, the
    per-sample per-neuron spike counts ``sum_t z_t`` of the LIF/ALIF
    layers (the reference's ``isinstance(layer, LIFLayer)`` filter,
    snn.py:268: no Izhikevich, no readout).

    ``_upto`` (private, for the deep dispatch): process layers
    ``0.._upto`` only and return the last one's time-major ``(T, B,
    width)`` trace (and the counts dict with ``return_spike_counts``)."""
    dev = resolve_device(device)
    compute_dtype = _dtype(cfg.compute_dtype)
    matmul_dtype = _dtype(cfg.matmul_dtype_eff)
    if first_layer_output is not None:
        x = None
        batch = first_layer_output.shape[1]
    elif first_layer_currents is not None:
        x = None
        batch = first_layer_currents.shape[1]
    else:
        x = format_inputs(cfg, torch.as_tensor(inputs, device=dev),
                          compute_dtype)
        batch = x.shape[0]
    training = _needs_grad(params)
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

    def collect_counts(name, lcfg, z_tm):
        if counts is not None and type(lcfg) in (LIFConfig, ALIFConfig):
            counts[name] = z_tm.to(torch.float32).sum(0)

    x_tm = None  # layer outputs are time-major (T, B, width)
    for idx, (name, lcfg) in enumerate(cfg.layer_configs):
        if _upto is not None and idx > _upto:
            break
        if idx == 0 and first_layer_output is not None:
            x_tm = first_layer_output  # keeps the kernel's trace dtype
            collect_counts(name, lcfg, x_tm)
            continue
        lparams = cparams[name]
        step_fn = STEP_FNS[type(lcfg)]
        w_rec_eff = masked_recurrent(lcfg, lparams)
        if w_rec_eff is not None and w_rec_eff.dtype != matmul_dtype:
            w_rec_eff = w_rec_eff.to(matmul_dtype)
        if (x_tm is not None and initial_state is None
                and _mid_layer_fusible(cfg, lcfg, return_hidden, dev,
                                       training)):
            x_tm = _fused_mid_layer(cfg, lcfg, lparams, x_tm, w_rec_eff,
                                    matmul_dtype)
            collect_counts(name, lcfg, x_tm)
            continue
        if x_tm is None and first_layer_currents is not None:
            currents = first_layer_currents.to(compute_dtype)
        elif x_tm is None:
            currents = mm(x, lparams["w_in"]).transpose(0, 1)
        else:
            currents = mm(x_tm, lparams["w_in"])
        if initial_state is None and _layer_scan_fusible(
                cfg, lcfg, return_hidden, dev, training):
            # (an initial state takes the loop: the kernels start at rest)
            x_tm = _layer_scan(cfg, lcfg, lparams, currents, w_rec_eff)
            collect_counts(name, lcfg, x_tm)
            continue
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
        collect_counts(name, lcfg, x_tm)
    if _upto is not None:
        return (x_tm, counts) if return_spike_counts else x_tm
    trace = x_tm.transpose(0, 1).to(torch.float32)
    if return_spike_counts:
        return trace, hidden, counts
    return trace, hidden


def _kernels_on(cfg: SNNConfig, device: torch.device, kind: str) -> bool:
    """The gates every kernel shares: ``use_kernels`` and float32
    compute."""
    if not cfg.use_kernels:
        return False
    if _dtype(cfg.compute_dtype) != torch.float32:
        if device.type == "cuda":
            _log_fused_fallback(
                kind, "compute_dtype != float32; for the bf16 recipe keep "
                "compute_dtype='float32' and set matmul_dtype='bfloat16'",
                _level=logging.WARNING, compute_dtype=cfg.compute_dtype)
        return False
    return True


def _beta_rho(lcfg, lparams):
    """(alif, beta, rho) of a LIF/ALIF layer: beta from the parameters
    under ``learn_beta``, else the config's; LIF passes zeros."""
    alif = type(lcfg) is ALIFConfig
    if not alif:
        return False, 0.0, 0.0
    return True, (lparams["beta"] if lcfg.learn_beta else lcfg.beta), lcfg.rho


def _mid_layer_fusible(cfg: SNNConfig, lcfg, return_hidden: bool,
                       device: torch.device, training: bool = False) -> bool:
    """Run this layer past the first as one mid call?  LIF/ALIF, no
    hidden traces, and a shape the kernel (with ``training`` its backward
    too) covers on ``device``."""
    if return_hidden or type(lcfg) not in (LIFConfig, ALIFConfig):
        return False
    if not _kernels_on(cfg, device, "mid layer"):
        return False
    ok = fused_mid_supported(
        cfg.int_time_steps, lcfg.input_size, lcfg.output_size,
        recurrent=lcfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            "mid layer", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, hidden_in=lcfg.input_size,
            hidden=lcfg.output_size, matmul_dtype=cfg.matmul_dtype_eff,
            training=training)
    return ok


def _izh_layer_fusible(cfg: SNNConfig, lcfg, return_hidden: bool,
                       device: torch.device, training: bool = False) -> bool:
    """Scan this Izhikevich layer's precomputed currents in one
    ``izh_scan`` call?  No hidden traces, and a shape the kernel (with
    ``training`` its backward too) covers on ``device`` (the JAX package's
    ``_pallas_layer_eligible``)."""
    if return_hidden or type(lcfg) is not IzhikevichConfig:
        return False
    if not _kernels_on(cfg, device, "Izhikevich scan"):
        return False
    ok = izh_scan_supported(
        cfg.int_time_steps, lcfg.output_size,
        recurrent=lcfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            "Izhikevich scan", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, hidden=lcfg.output_size,
            matmul_dtype=cfg.matmul_dtype_eff, training=training)
    return ok


def _layer_scan_fusible(cfg: SNNConfig, lcfg, return_hidden: bool,
                        device: torch.device, training: bool = False) -> bool:
    """Scan this layer's precomputed currents in one call (the JAX package's
    ``_pallas_layer_eligible``)?  An Izhikevich layer as
    :func:`_izh_layer_fusible`; a LIF/ALIF layer with no hidden traces and
    a shape ``rec_scan_supported`` (recurrent) or ``scan_supported``
    (feedforward) covers on ``device``."""
    if type(lcfg) is IzhikevichConfig:
        return _izh_layer_fusible(cfg, lcfg, return_hidden, device, training)
    if return_hidden or type(lcfg) not in (LIFConfig, ALIFConfig):
        return False
    rec = lcfg.use_recurrent_connection
    kind = "recurrent scan" if rec else "feedforward scan"
    if not _kernels_on(cfg, device, kind):
        return False
    supported = rec_scan_supported if rec else scan_supported
    ok = supported(
        cfg.int_time_steps, lcfg.output_size,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            kind, "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, hidden=lcfg.output_size,
            matmul_dtype=cfg.matmul_dtype_eff, training=training)
    return ok


def _layer_scan(cfg: SNNConfig, lcfg, lparams, currents: torch.Tensor,
                w_rec_eff) -> torch.Tensor:
    """One layer's scan over its currents ``(T, B, H)`` (the JAX package's
    ``_pallas_layer_scan``): ``izh_scan`` for Izhikevich,
    ``rec_{alif,lif}_scan`` for a recurrent LIF/ALIF layer,
    ``{alif,lif}_scan`` for a feedforward one.  LIF/ALIF spikes come back
    in the matmul dtype (``W_rec``'s; the feedforward scan is given it)."""
    w_rec = None if w_rec_eff is None else w_rec_eff.contiguous()
    if type(lcfg) is IzhikevichConfig:
        return izh_scan(currents, w_rec, izh_kernel_params(lcfg), lcfg.gamma,
                        lcfg.spike_func)
    # Under matmul_dtype=bfloat16 the traces are stored in bf16 (spikes
    # exact); the feedforward scan has no W_rec to carry the type.
    trace_dtype = cfg.matmul_dtype_eff
    if type(lcfg) is ALIFConfig:
        beta = lparams["beta"] if lcfg.learn_beta else lcfg.beta
        if w_rec is None:
            return alif_scan(currents, beta, lcfg.alpha, lcfg.rho,
                             lcfg.threshold, lcfg.gamma, lcfg.spike_func,
                             trace_dtype)
        return rec_alif_scan(currents, w_rec, beta, lcfg.alpha, lcfg.rho,
                             lcfg.threshold, lcfg.gamma, lcfg.spike_func)
    if w_rec is None:
        return lif_scan(currents, lcfg.alpha, lcfg.threshold, lcfg.gamma,
                        lcfg.spike_func, trace_dtype)
    return rec_lif_scan(currents, w_rec, lcfg.alpha, lcfg.threshold,
                        lcfg.gamma, lcfg.spike_func)


def _fused_mid_layer(cfg: SNNConfig, lcfg, lparams, z_in, w_rec_eff,
                     matmul_dtype) -> torch.Tensor:
    """One LIF/ALIF layer past the first as a mid call: ``z_in (T, B,
    Hin)`` -> ``z (T, B, H)``."""
    w_in = lparams["w_in"].to(matmul_dtype).contiguous()
    alif, beta, rho = _beta_rho(lcfg, lparams)
    common = (cfg.int_time_steps, alif, lcfg.alpha, rho, lcfg.threshold,
              lcfg.gamma, lcfg.spike_func)
    if w_rec_eff is not None:
        return fused_mid_rec_scan(z_in, w_in, w_rec_eff.contiguous(), beta,
                                  *common)
    return fused_mid_ff_scan(z_in, w_in, beta, *common)


def _layer0_fusible(cfg: SNNConfig, enc, return_hidden: bool,
                    device: torch.device, training: bool = False) -> bool:
    """Run layer 0 as one encode + scan call?  A LIF/ALIF/Izhikevich first
    layer, on-device encoding at ``int_time_steps``, no hidden traces, and
    a shape the kernel covers on ``device``."""
    first_cfg = cfg.layer_configs[0][1]
    if return_hidden or type(first_cfg) not in (LIFConfig, ALIFConfig,
                                                IzhikevichConfig):
        return False
    if not (enc.as_timeseries and enc.n_steps == cfg.int_time_steps):
        return False
    if not _kernels_on(cfg, device, "encode + layer 0"):
        return False
    supported = (fused_izh_supported if type(first_cfg) is IzhikevichConfig
                 else fused_supported)
    ok = supported(
        cfg.int_time_steps, cfg.input_size, first_cfg.output_size,
        recurrent=first_cfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training, use_periods=enc.use_periods)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            "encode + layer 0", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, n_features=cfg.input_size,
            hidden=first_cfg.output_size, matmul_dtype=cfg.matmul_dtype_eff,
            training=training)
    return ok


def _encode_matmul_fusible(cfg: SNNConfig, enc, device: torch.device,
                           training: bool = False) -> bool:
    """Compute the first layer's currents from the latencies in one call
    (the JAX package's ``encode_matmul_supported`` branch of
    ``apply_pixels``)?  On-device encoding at ``int_time_steps`` and a
    shape the kernel (with ``training`` its backward too) covers on
    ``device``."""
    if not (enc.as_timeseries and enc.n_steps == cfg.int_time_steps):
        return False
    if not _kernels_on(cfg, device, "encode matmul"):
        return False
    first_cfg = cfg.layer_configs[0][1]
    ok = encode_matmul_supported(
        cfg.int_time_steps, first_cfg.output_size, n_features=cfg.input_size,
        device=device, training=training, use_periods=enc.use_periods)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            "encode matmul", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, n_features=cfg.input_size,
            hidden=first_cfg.output_size, training=training)
    return ok


def apply_pixels(cfg: SNNConfig, params: Params, pixels, enc, *,
                 return_hidden: bool = False,
                 return_spike_counts: bool = False,
                 _upto: Optional[int] = None, device="cuda"):
    """Simulate from raw pixels ``(B, F)``, encoding on the device
    (``enc`` is a ``data.datasets.EncodeConfig``).

    A LIF/ALIF/Izhikevich first layer runs as one encode + input product +
    scan call from the integer latencies (ops/fused.py, ops/fused_izh.py),
    so the ``(B, T, F)`` spike tensor never exists; where that call does not
    cover the layer, its currents come from the latencies in one call
    (ops/encode.py) and feed :func:`apply`; otherwise ``encode_spikes``
    does."""
    dev = resolve_device(device)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    rest = dict(return_hidden=return_hidden,
                return_spike_counts=return_spike_counts, _upto=_upto,
                device=dev)
    if not enc.as_timeseries:
        return apply(cfg, params, pixels, **rest)
    training = _needs_grad(params)
    if _layer0_fusible(cfg, enc, return_hidden, dev, training):
        first_name, first_cfg = cfg.layer_configs[0]
        matmul_dtype = _dtype(cfg.matmul_dtype_eff)
        latencies = pixels_to_firing_periods(
            pixels, t_max=float(cfg.int_time_steps), tau=enc.tau,
            thr=enc.thr, epsilon=enc.epsilon,
        ).contiguous()
        lparams0 = {k: v.to(dev) for k, v in params[first_name].items()}
        w0 = lparams0["w_in"].to(matmul_dtype).contiguous()
        w_rec_eff = masked_recurrent(first_cfg, lparams0)
        if w_rec_eff is not None:
            w_rec_eff = w_rec_eff.to(matmul_dtype).contiguous()
        if type(first_cfg) is IzhikevichConfig:
            z0 = fused_encode_izh_scan(
                latencies, w0, w_rec_eff, izh_kernel_params(first_cfg),
                cfg.int_time_steps, enc.use_periods, first_cfg.gamma,
                first_cfg.spike_func)
            return apply(cfg, params, None, first_layer_output=z0, **rest)
        alif, beta, rho = _beta_rho(first_cfg, lparams0)
        common = (cfg.int_time_steps, enc.use_periods, alif, first_cfg.alpha,
                  rho, first_cfg.threshold, first_cfg.gamma,
                  first_cfg.spike_func)
        if w_rec_eff is not None:
            z0 = fused_encode_rec_scan(latencies, w0, w_rec_eff, beta,
                                       *common)
        else:
            z0 = fused_encode_ff_scan(latencies, w0, beta, *common)
        return apply(cfg, params, None, first_layer_output=z0, **rest)
    if _encode_matmul_fusible(cfg, enc, dev, training):
        w0 = (params[cfg.layer_configs[0][0]]["w_in"].to(dev)
              .to(_dtype(cfg.matmul_dtype_eff)).contiguous())
        latencies = pixels_to_firing_periods(
            pixels, t_max=float(cfg.int_time_steps), tau=enc.tau,
            thr=enc.thr, epsilon=enc.epsilon,
        ).contiguous()
        currents0 = encoded_input_matmul(latencies, w0, cfg.int_time_steps,
                                         enc.use_periods)
        return apply(cfg, params, None, first_layer_currents=currents0,
                     **rest)
    inputs = encode_spikes(
        pixels, n_steps=enc.n_steps, use_periods=enc.use_periods,
        tau=enc.tau, thr=enc.thr, epsilon=enc.epsilon)
    return apply(cfg, params, inputs, **rest)


def _head_fusible(cfg: SNNConfig, enc, device: torch.device,
                  training: bool = False) -> bool:
    """Whole-network head available: one LIF/ALIF/Izhikevich hidden layer,
    the max-over-time readout, on-device encoding at ``int_time_steps`` and
    float32 compute; with ``training`` the backward kernel must cover the
    shape too.  On the card every gate a config hits is logged."""
    on_card = device.type == "cuda"
    if not _kernels_on(cfg, device, "whole-network head"):
        return False
    if not (enc.as_timeseries and enc.n_steps == cfg.int_time_steps):
        return False
    if cfg.readout_mth != ReadoutMth.RNN:
        return False
    layer_cfgs = cfg.layer_configs
    first_cfg, last_cfg = layer_cfgs[0][1], layer_cfgs[-1][1]
    if len(layer_cfgs) != 2:
        return False  # no hidden layer, or the deep dispatch
    if type(first_cfg) not in (LIFConfig, ALIFConfig, IzhikevichConfig):
        return False
    supported = (fused_izh_head_supported
                 if type(first_cfg) is IzhikevichConfig
                 else fused_head_supported)
    ok = supported(
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
    alif, beta, rho = _beta_rho(first_cfg, lparams0)
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
    carry the gradient back to the float32 leaves).  An Izhikevich head
    with ``counts`` returns ``(logits, {})``: the reference collects counts
    of LIF/ALIF layers only (snn.py:268), as :func:`apply` does."""
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
    if type(first_cfg) is IzhikevichConfig:
        w_rec_eff = masked_recurrent(first_cfg, lparams0)
        if w_rec_eff is not None:
            w_rec_eff = w_rec_eff.to(matmul_dtype).contiguous()
        logits = fused_encode_izh_scan_head(
            latencies, w0, w_rec_eff, w_out, b_out,
            izh_kernel_params(first_cfg), cfg.int_time_steps,
            enc.use_periods, first_cfg.gamma, last_cfg.kappa,
            first_cfg.spike_func)
        return (logits, {}) if counts else logits
    out = _lif_alif_head_call(cfg, first_cfg, last_cfg, lparams0, latencies,
                              w0, w_out, b_out, enc, counts=counts)
    if counts:
        return out[0], {first_name: out[1]}
    return out


def _twolayer_head_fusible(cfg: SNNConfig, enc, device: torch.device,
                           training: bool = False) -> bool:
    """The two-layer pair available: exactly two hidden layers of one
    LIF/ALIF class with equal ``alpha``, ``threshold``, ``gamma``,
    ``spike_func``, ``use_recurrent_connection`` (and for ALIF ``rho`` and
    ``learn_beta``), the max-over-time readout, on-device encoding at
    ``int_time_steps``, float32 compute, and a shape the kernels (with
    ``training`` the backward too) cover on ``device``.  A hand-built
    config with per-layer scalar overrides takes the composed deep
    dispatch, which supports them."""
    if cfg.readout_mth != ReadoutMth.RNN:
        return False
    if not (enc.as_timeseries and enc.n_steps == cfg.int_time_steps):
        return False
    layer_cfgs = cfg.layer_configs
    if len(layer_cfgs) != 3:
        return False
    h0_cfg, h1_cfg, last_cfg = (lc for _, lc in layer_cfgs)
    if type(last_cfg) is not ReadoutConfig:
        return False
    if type(h0_cfg) not in (LIFConfig, ALIFConfig):
        return False
    if type(h1_cfg) is not type(h0_cfg):
        return False
    names = ["alpha", "threshold", "gamma", "spike_func",
             "use_recurrent_connection"]
    if type(h0_cfg) is ALIFConfig:
        names += ["rho", "learn_beta"]
    if any(getattr(h0_cfg, n) != getattr(h1_cfg, n) for n in names):
        return False
    if not _kernels_on(cfg, device, "two-layer whole-network head"):
        return False
    ok = fused2_head_supported(
        cfg.int_time_steps, h0_cfg.input_size, h0_cfg.output_size,
        h1_cfg.output_size, last_cfg.output_size,
        recurrent=h0_cfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training, use_periods=enc.use_periods)
    if not ok and device.type == "cuda":
        _log_fused_fallback(
            "two-layer whole-network head", "shape exceeds the kernels' "
            "limits (the composed layer-0 + mid-head dispatch takes over)",
            n_steps=cfg.int_time_steps, n_features=h0_cfg.input_size,
            h1=h0_cfg.output_size, h2=h1_cfg.output_size,
            n_out=last_cfg.output_size, matmul_dtype=cfg.matmul_dtype_eff,
            training=training)
    return ok


def _twolayer_head_call(cfg: SNNConfig, params: Params, pixels, enc,
                        counts: bool = False):
    """The two-hidden-layer network as one call of the fused2 pair:
    per-layer betas, each ``W_rec`` eye-masked before the cast to the
    matmul dtype.  Returns logits ``(B, O)``, or ``(logits, (cnt0, cnt1))``
    with ``counts``."""
    (n0, c0), (n1, c1), (nl, cl) = cfg.layer_configs
    latencies = pixels_to_firing_periods(
        pixels, t_max=float(cfg.int_time_steps), tau=enc.tau, thr=enc.thr,
        epsilon=enc.epsilon,
    ).contiguous()
    md = _dtype(cfg.matmul_dtype_eff)
    lp0, lp1 = params[n0], params[n1]
    w0 = lp0["w_in"].to(md).contiguous()
    w1 = lp1["w_in"].to(md).contiguous()
    w_out = params[nl]["w_in"].to(md).contiguous()
    b_out = params[nl]["b"].to(torch.float32).contiguous()
    alif, beta0, rho = _beta_rho(c0, lp0)
    beta1 = _beta_rho(c1, lp1)[1]
    common = (cfg.int_time_steps, enc.use_periods, alif, c0.alpha, rho,
              c0.threshold, c0.gamma, cl.kappa, c0.spike_func)
    w0r = masked_recurrent(c0, lp0)
    if w0r is not None:
        w0r = w0r.to(md).contiguous()
        w1r = masked_recurrent(c1, lp1).to(md).contiguous()
        fn = fused2_rec_head_counts if counts else fused2_rec_head
        return fn(latencies, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out,
                  *common)
    fn = fused2_ff_head_counts if counts else fused2_ff_head
    return fn(latencies, w0, beta0, w1, beta1, w_out, b_out, *common)


def _deep_head_fusible(cfg: SNNConfig, enc, device: torch.device,
                       training: bool = False) -> bool:
    """Deep-network head available: two or more hidden layers, the last
    one LIF/ALIF, and the max-over-time readout.  That last (hidden,
    readout) pair then runs as one mid-head call; the trunk (layers
    0..N-2) keeps its per-layer dispatch.  Two-hidden configs reach it
    where the two-layer pair's gate says no."""
    layer_cfgs = cfg.layer_configs
    if len(layer_cfgs) < 3 or cfg.readout_mth != ReadoutMth.RNN:
        return False
    lh_cfg, last_cfg = layer_cfgs[-2][1], layer_cfgs[-1][1]
    if type(last_cfg) is not ReadoutConfig:
        return False
    if type(lh_cfg) not in (LIFConfig, ALIFConfig):
        return False
    if not _kernels_on(cfg, device, "mid head (deep network)"):
        return False
    on_card = device.type == "cuda"
    ok = fused_mid_head_supported(
        cfg.int_time_steps, lh_cfg.input_size, lh_cfg.output_size,
        last_cfg.output_size, recurrent=lh_cfg.use_recurrent_connection,
        itemsize=_dtype(cfg.matmul_dtype_eff).itemsize, device=device,
        training=training)
    if not ok and on_card:
        _log_fused_fallback(
            "mid head (deep network)", "shape exceeds the kernel's limits",
            n_steps=cfg.int_time_steps, hidden_in=lh_cfg.input_size,
            hidden=lh_cfg.output_size, n_out=last_cfg.output_size,
            matmul_dtype=cfg.matmul_dtype_eff, training=training)
    return ok


def _mid_head_call(cfg: SNNConfig, params: Params, x_tm: torch.Tensor,
                   counts: bool = False):
    """The last hidden layer + readout as one mid-head call.  ``x_tm`` is
    the trunk's time-major ``(T, B, Hin)`` spike trace; returns logits
    ``(B, O)``, or ``(logits, counts (B, H))`` with ``counts``."""
    (lh_name, lh_cfg), (last_name, last_cfg) = cfg.layer_configs[-2:]
    matmul_dtype = _dtype(cfg.matmul_dtype_eff)
    lp = params[lh_name]
    w_in = lp["w_in"].to(matmul_dtype).contiguous()
    w_out = params[last_name]["w_in"].to(matmul_dtype).contiguous()
    b_out = params[last_name]["b"].to(torch.float32).contiguous()
    alif, beta, rho = _beta_rho(lh_cfg, lp)
    common = (cfg.int_time_steps, alif, lh_cfg.alpha, rho, lh_cfg.threshold,
              lh_cfg.gamma, last_cfg.kappa, lh_cfg.spike_func)
    w_rec_eff = masked_recurrent(lh_cfg, lp)
    if w_rec_eff is not None:
        w_rec_eff = w_rec_eff.to(matmul_dtype).contiguous()
        fn = (fused_mid_rec_scan_head_counts if counts
              else fused_mid_rec_scan_head)
        return fn(x_tm, w_in, w_rec_eff, beta, w_out, b_out, *common)
    fn = fused_mid_ff_scan_head_counts if counts else fused_mid_ff_scan_head
    return fn(x_tm, w_in, beta, w_out, b_out, *common)


def forward_logits_pixels(cfg: SNNConfig, params: Params, pixels, enc, *,
                          device="cuda") -> torch.Tensor:
    """Raw pixels ``(B, F)`` -> class logits ``(B, O)``, encoding inside;
    differentiable with respect to ``params`` on both paths.

    Head-fusible configs run the whole network as one head call,
    two-hidden ones as one call of the two-layer pair, deeper ones the
    trunk layer by layer and the last hidden layer with the readout as one
    mid-head call; the rest compose :func:`apply_pixels` with
    :func:`prediction_logits`."""
    dev = resolve_device(device)
    params = _to(params, dev)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    training = _needs_grad(params)
    if _head_fusible(cfg, enc, dev, training):
        return _head_forward(cfg, params, pixels, enc, counts=False)
    if _twolayer_head_fusible(cfg, enc, dev, training):
        return _twolayer_head_call(cfg, params, pixels, enc)
    if _deep_head_fusible(cfg, enc, dev, training):
        x_tm = apply_pixels(cfg, params, pixels, enc,
                            _upto=len(cfg.layer_configs) - 3, device=dev)
        return _mid_head_call(cfg, params, x_tm)
    trace, _ = apply_pixels(cfg, params, pixels, enc, device=dev)
    return prediction_logits(cfg, trace)


def forward_logits_counts_pixels(cfg: SNNConfig, params: Params, pixels, enc,
                                 *, device="cuda"):
    """Raw pixels ``(B, F)`` -> ``(logits, spike_counts)``, encoding
    inside.

    ``spike_counts`` is ``{layer: (B, width) float32}`` for the LIF/ALIF
    layers: all the spike regularizers (train/losses.py) need, without
    the ``(B, T, H)`` hidden traces.  Head-fusible configs keep the
    whole-network head (its ``_counts`` variants; an Izhikevich head
    returns ``{}``), two-hidden ones the two-layer pair's (both layers'
    counts from the kernel) and deeper ones the mid head's; the rest run
    :func:`apply_pixels` with ``return_spike_counts=True``."""
    dev = resolve_device(device)
    params = _to(params, dev)
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    training = _needs_grad(params)
    if _head_fusible(cfg, enc, dev, training):
        return _head_forward(cfg, params, pixels, enc, counts=True)
    if _twolayer_head_fusible(cfg, enc, dev, training):
        (n0, _), (n1, _) = cfg.layer_configs[:2]
        logits, (cnt0, cnt1) = _twolayer_head_call(cfg, params, pixels, enc,
                                                   counts=True)
        return logits, {n0: cnt0, n1: cnt1}
    if _deep_head_fusible(cfg, enc, dev, training):
        # The trunk's traces exist anyway (their counts are a sum over
        # time); the last hidden layer's come from the mid-head call.
        x_tm, counts = apply_pixels(
            cfg, params, pixels, enc, return_spike_counts=True,
            _upto=len(cfg.layer_configs) - 3, device=dev)
        logits, cnt_last = _mid_head_call(cfg, params, x_tm, counts=True)
        counts[cfg.layer_configs[-2][0]] = cnt_last
        return logits, counts
    trace, _, counts = apply_pixels(cfg, params, pixels, enc,
                                    return_spike_counts=True, device=dev)
    return prediction_logits(cfg, trace), counts


def stacked_head_fusible(cfg: SNNConfig, enc, device="cuda",
                         training: bool = False) -> bool:
    """Whether :func:`forward_logits_pixels_stacked` covers this config on
    ``device``: the whole-network head's gate (one LIF/ALIF/Izhikevich
    hidden layer, max-over-time readout, on-device encoding at
    ``int_time_steps``, float32 compute, the shape within the kernels'
    limits, with ``training`` the backward's too).  The stacked launches
    take each replica with the single kernels' plan, so their gate is the
    single gate."""
    return _head_fusible(cfg, enc, resolve_device(device), training)


def forward_logits_pixels_stacked(cfg: SNNConfig, stacked_params: Params,
                                  pixels, enc, *,
                                  device="cuda") -> torch.Tensor:
    """All replicas of a multi-seed ensemble in one stacked head call.

    ``stacked_params`` carries a leading replica axis S on every leaf (the
    layout of parallel/ensemble.py); the pixels ``(B, F)`` and their
    latencies, computed once, are shared by every replica.  Returns logits
    ``(S, B, O)``, differentiable in the params: on the card one launch of
    ``fused_head_fwd_stacked`` (``fused_izh_fwd_stacked``) for inference,
    of the ``_train_stacked`` forward and the ``_bwd_stacked`` backward for
    training; each replica's logits and gradients equal a single
    :func:`forward_logits_pixels` bit for bit.  Raises on a config that is
    not stacked-head-fusible: gate on :func:`stacked_head_fusible` and run
    the replicas one by one instead."""
    dev = resolve_device(device)
    params = _to(stacked_params, dev)
    if not stacked_head_fusible(cfg, enc, dev, _needs_grad(params)):
        raise ValueError(
            "forward_logits_pixels_stacked: config is not stacked-head-"
            "fusible (more than one hidden layer, another readout or "
            "encoding, compute_dtype != float32, or a shape past the "
            "kernels' limits) -- gate on stacked_head_fusible(cfg, enc) and "
            "use per-replica forward_logits_pixels instead."
        )
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    return _head_forward(cfg, params, pixels, enc, counts=False)


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


def rec_scan_body_note(n_steps: int, hidden: int, itemsize: int, dev,
                       training: bool) -> tuple:
    """(reason suffix, path mode) of the recurrent scan's bodies on the
    card, each named in the reason: "the tensor-core cluster body (mma)",
    or the CUDA-core body (every float32 chain); a shape past the cluster
    body's limits, whose forward takes the CUDA-core body too, gives a path
    ending in ``[cuda-core]``."""
    parts = ("the forward", "the backward's chain")
    bodies = rec_bodies(n_steps, hidden, itemsize=itemsize, device=dev)
    if not training:
        parts, bodies = parts[:1], bodies[:1]
    note, mode = "", ""
    if "mma" in bodies:
        note = ("; the tensor-core cluster body (mma: W_rec split across a "
                "thread-block cluster) in " + " and ".join(
                    k for k, b in zip(parts, bodies) if b == "mma"))
    if bodies[0] == "cuda-core":
        mode = "[cuda-core]"
    if "cuda-core" in bodies:
        note += ("; the CUDA-core body (a float32 chain, or W_rec's pieces "
                 "past a cluster's shared memory) in " + " and ".join(
                     k for k, b in zip(parts, bodies) if b == "cuda-core"))
    return note, mode


def explain_dispatch(cfg: SNNConfig, enc=None, device="cuda",
                     training: bool = False, stacked: bool = False) -> list:
    """Which implementation :func:`forward_logits_pixels` (with ``enc``)
    or :func:`apply` runs for each layer, and why: a list of ``{"layer",
    "path", "reason"}`` dicts in execution order.  Paths on the card:
    ``cuda:fused_head_fwd`` (the whole network, inference),
    ``cuda:fused_layer0_fwd`` (encode + layer 0), ``cuda:fused_mid_fwd``
    (a layer past the first) and ``cuda:fused_mid_fwd[head]`` (the last
    hidden layer + readout), and for Izhikevich layers
    ``cuda:fused_izh_fwd`` (the whole network), ``cuda:fused_izh_layer0_fwd``
    and ``cuda:izh_scan_fwd`` (a layer past the first, on its currents);
    with ``training`` each names the pair a step launches
    (``cuda:fused_head_fwd_train+fused_head_bwd``,
    ``cuda:fused_layer0_fwd+fused_layer0_bwd``, ...).  On the CPU their
    plain versions: ``torch:fused_head_reference``,
    ``torch:fused_layer0_reference``, ``torch:fused_mid_reference``,
    ``torch:fused_mid_reference[head]``, ``torch:fused_izh_head_reference``,
    ``torch:fused_izh_layer0_reference``, ``torch:izh_scan_reference``.
    The head kernels (LIF/ALIF and Izhikevich, single and stacked), the
    mid layer's and the two-layer pairs name their bodies on the card (the
    forward's and, training, the backward's chain's): the tensor-core body,
    "the tensor-core body (mma)" in the reason; the per-unit body past its
    limits, a path ending in ``[per-unit]``; training, the mid layer's and
    the two-layer backward's input cotangent ``gzin_mma``.  A first layer
    (LIF/ALIF and Izhikevich) and an Izhikevich layer past the first
    (``izh_scan``) name their forward's and, training, their backward's
    chain's body the same way.
    A two-hidden-layer network that takes the two-layer pair is one row:
    ``cuda:fused2_fwd`` (``cuda:fused2_fwd_train+fused2_bwd`` training),
    ``torch:fused2_reference`` on the CPU.  The unfused tier gives a layer
    up to two rows: ``cuda:encode_matmul_fwd`` (a first layer's currents
    from the latencies; ``+encode_matmul_bwd`` training) and
    ``cuda:rec_scan_fwd`` (a recurrent LIF/ALIF layer's scan over its
    currents; ``cuda:rec_scan_fwd_train+rec_scan_bwd`` training; "the
    tensor-core cluster body (mma)" or the CUDA-core body in the reason,
    and past the cluster body's limits a path ending in ``[cuda-core]``) or
    ``cuda:scan_fwd`` (a feedforward one's; ``cuda:scan_fwd_train+scan_bwd``
    training), on the CPU ``torch:encode_matmul_reference``,
    ``torch:rec_scan_reference`` and ``torch:scan_reference``.
    ``torch:loop`` is the per-step loop.  With ``stacked`` it describes
    :func:`forward_logits_pixels_stacked` (the replicas of an ensemble):
    ``cuda:fused_head_fwd_stacked`` (``cuda:fused_head_fwd_train_stacked+
    fused_head_bwd_stacked`` training; ``fused_izh_*_stacked`` for an
    Izhikevich head), ``torch:fused_head_stacked_reference`` (or
    ``torch:fused_izh_head_stacked_reference``) on the CPU; a config the
    stacked call does not cover lists the per-replica dispatch, each reason
    ending in "(per replica)".  It fires the same fallback logs the real
    dispatch would."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    layer_cfgs = cfg.layer_configs
    names = tuple(name for name, _ in layer_cfgs)

    def path(fwd, bwd, plain, mode=""):
        if not on_card:
            return f"torch:{plain}{mode}"
        return f"cuda:{fwd}{'+' + bwd if training else ''}{mode}"

    also = ", reverse-time BPTT in another" if training else ""

    def gwin_note() -> str:
        """bwd_gwin's copied stage, where a training call launches it (every
        backward of an encoded first layer) and takes it."""
        if not (on_card and training):
            return ""
        why = gwin_copied_stage(
            dev, cfg.input_size, layer_cfgs[0][1].output_size,
            cfg.int_time_steps, _dtype(cfg.matmul_dtype_eff).itemsize,
            enc.use_periods)
        return ("" if why is None else "; g_W_in's rows copied into shared "
                f"memory by the threads ({why}, no TMA ring)")

    def gbits_note(what: str, h: int, itemsize: int) -> str:
        """gbits_mma (ops/gbits.py), where a training call launches it for
        the gradients ``what`` over a d of ``h`` columns in ``itemsize``
        bytes: a tensor-core product, its d streamed through a TMA ring,
        or copied by its threads where TMA cannot take the rows."""
        if not (on_card and training):
            return ""
        row = h * itemsize
        how = ("" if row % 16 == 0 and row >= 128 else ", d copied by its "
               "threads (H * itemsize not a multiple of 16 bytes, or below "
               "128)")
        return f"; {what} by gbits_mma on tensor cores{how}"

    md_size = _dtype(cfg.matmul_dtype_eff).itemsize

    def rec_of(lcfg) -> bool:
        return bool(getattr(lcfg, "use_recurrent_connection", False))

    where = "" if on_card else " (plain version on the CPU)"
    izh = type(layer_cfgs[0][1]) is IzhikevichConfig

    def pair_body(bodies, limits: str):
        """(reason note, path mode) of a mid-layer or two-layer kernel pair's
        bodies on the card: the forward's and (training) the backward's
        chain, each the tensor-core body or, past its limits (the
        forward's ``limits``), the per-unit body, a path ending in
        ``[per-unit]``; training, the backward's input cotangent on tensor
        cores."""
        if not on_card:
            return "", ""
        parts = zip(("the forward", "the backward's chain"), bodies,
                    (limits, "O > 16, H > 256, or the weights' bf16 pieces "
                     "past a block's shared memory"))
        note, mode = "", ""
        for part, body, why in parts:
            if body == "mma":
                note += f"; the tensor-core body (mma) in {part}"
            else:
                note += f"; the per-unit body ({why}) in {part}"
                mode = "[per-unit]"
        if training:
            note += ("; the input's cotangent dcur @ W_in^T by gzin_mma on "
                     "tensor cores")
        return note, mode

    def mid_body(n_in, lcfg, n_out):
        if not on_card:
            return "", ""
        return pair_body(mid_bodies(
            cfg.int_time_steps, n_in, lcfg.output_size, n_out,
            recurrent=rec_of(lcfg), itemsize=md_size, device=dev,
            training=training),
            "O > 16, H > 256, an input past about 1.5 H, or the weights' bf16 "
            "pieces past a block's shared memory")
    def layer0_body(lcfg):
        """(reason note, path mode) of a first layer's kernels on the card:
        the forward on the head's tensor-core body and, training, the
        backward's chain on the tensor-core chain body, or past their
        limits the per-unit bodies (a path ending in ``[per-unit]``)."""
        if not on_card:
            return "", ""
        bodies = (izh_layer0_bodies if izh else layer0_bodies)(
            cfg.int_time_steps, cfg.input_size, lcfg.output_size,
            recurrent=rec_of(lcfg), itemsize=md_size, device=dev,
            training=training,
            use_periods=enc is not None and enc.use_periods)
        why = "H > 256, or W_rec's bf16 pieces past a block's shared memory"
        note = ""
        for part, body in zip(("the forward", "the backward's chain"),
                              bodies):
            note += (f"; the tensor-core body (mma) in {part}"
                     if body == "mma" else
                     f"; the per-unit body ({why}) in {part}")
        return note, "" if set(bodies) == {"mma"} else "[per-unit]"

    def izh_scan_body(lcfg):
        """(reason note, path mode) of ``izh_scan``'s kernels on the card:
        the forward on the first layers' tensor-core body and, training,
        the backward's chain on the tensor-core chain body, or past their
        limits the per-unit bodies (a path ending in ``[per-unit]``)."""
        if not on_card:
            return "", ""
        bodies = izh_scan_bodies(
            cfg.int_time_steps, lcfg.output_size, recurrent=rec_of(lcfg),
            itemsize=md_size, device=dev, training=training)
        why = "H > 256, or W_rec's bf16 pieces past a block's shared memory"
        note = ""
        for part, body in zip(("the forward", "the backward's chain"),
                              bodies):
            note += (f"; the tensor-core body (mma) in {part}"
                     if body == "mma" else
                     f"; the per-unit body ({why}) in {part}")
        return note, "" if set(bodies) == {"mma"} else "[per-unit]"

    if enc is not None and _head_fusible(cfg, enc, dev, training):
        if izh:
            kernels = (KERNEL_IZH_TRAIN if training else KERNEL_IZH,
                       KERNEL_IZH_BWD, "fused_izh_head_reference")
            if stacked:
                kernels = (KERNEL_IZH_TRAIN_STACKED if training
                           else KERNEL_IZH_STACKED, KERNEL_IZH_BWD_STACKED,
                           "fused_izh_head_stacked_reference")
        elif stacked:
            kernels = (KERNEL_TRAIN_STACKED if training else KERNEL_STACKED,
                       KERNEL_BWD_STACKED, "fused_head_stacked_reference")
        else:
            kernels = (KERNEL_TRAIN if training else KERNEL, KERNEL_BWD,
                       "fused_head_reference")
        what = ("every replica of the ensemble on one shared batch"
                if stacked else "single-hidden-layer classifier with "
                "max-over-time readout")
        body, mode = "", ""
        if on_card:
            # The head's kernels run a shape on their tensor-core body or,
            # past its limits, on their per-unit body.
            (_, first_cfg), (_, last_cfg) = layer_cfgs
            itemsize = _dtype(cfg.matmul_dtype_eff).itemsize
            bodies = (izh_head_bodies if izh else head_bodies)(
                cfg.int_time_steps, cfg.input_size, first_cfg.output_size,
                last_cfg.output_size,
                recurrent=first_cfg.use_recurrent_connection,
                itemsize=itemsize, device=dev, training=training,
                use_periods=enc.use_periods)
            parts = ("the forward", "the backward's chain")
            if "mma" in bodies:
                body = "; the tensor-core body (mma) in " + " and ".join(
                    k for k, b in zip(parts, bodies) if b == "mma")
            if "per-unit" in bodies:
                mode = "[per-unit]"
                body += ("; the per-unit body (O > 16, H > 256, or the "
                         "weights' bf16 pieces past a block's shared memory) "
                         "in " + " and ".join(
                             k for k, b in zip(parts, bodies)
                             if b == "per-unit"))
        first = layer_cfgs[0][1]
        gb = (gbits_note("g_W_rec", first.output_size, md_size)
              if rec_of(first) else "")
        return [{
            "layer": names,
            "path": path(*kernels, mode=mode),
            "reason": what + ": encode + scan + readout + max in one call"
                      + also + body + gwin_note() + gb + where,
        }]
    if stacked:
        return [dict(e, reason=e["reason"] + " (per replica)")
                for e in explain_dispatch(cfg, enc, device, training)]
    if enc is not None and _twolayer_head_fusible(cfg, enc, dev, training):
        body, mode = "", ""
        if on_card:
            (_, c0), (_, c1), (_, c2) = layer_cfgs
            body, mode = pair_body(fused2_bodies(
                cfg.int_time_steps, cfg.input_size, c0.output_size,
                c1.output_size, c2.output_size, recurrent=rec_of(c0),
                itemsize=md_size, device=dev, training=training,
                use_periods=enc.use_periods), "O > 16, the two layers' "
                "units past 256, or the weights' bf16 pieces past a block's "
                "shared memory")
        return [{
            "layer": names,
            "path": path(KERNEL_2_TRAIN if training else KERNEL_2,
                         KERNEL_2_BWD, "fused2_reference", mode),
            "reason": "two-hidden-layer classifier with max-over-time "
                      "readout: encode + both hidden scans + readout + max "
                      "in one call" + also + body + gwin_note() + gbits_note(
                          "g_W1 and both g_W_rec" if rec_of(layer_cfgs[0][1])
                          else "g_W1", layer_cfgs[1][1].output_size,
                          md_size) + where,
        }]
    if not cfg.use_kernels:
        loop_reason = "use_kernels=False"
    elif _dtype(cfg.compute_dtype) != torch.float32:
        loop_reason = "compute_dtype != float32 turns every kernel off"
    else:
        loop_reason = "no CUDA kernel of this port covers this layer"
    deep = enc is not None and _deep_head_fusible(cfg, enc, dev, training)
    entries = []
    for idx, (name, lcfg) in enumerate(layer_cfgs):
        if deep and idx == len(layer_cfgs) - 2:
            body, mode = mid_body(layer_cfgs[idx - 1][1].output_size, lcfg,
                                  layer_cfgs[-1][1].output_size)
            entries.append({
                "layer": (name, names[-1]),
                "path": path(KERNEL_MID, KERNEL_MID_BWD,
                             "fused_mid_reference", "[head]" + mode),
                "reason": "deep network's last hidden layer + readout + "
                          "max over time in one call" + also + body
                          + gbits_note(
                              "g_W_in and g_W_rec" if rec_of(lcfg)
                              else "g_W_in", lcfg.output_size, md_size)
                          + where,
            })
            break
        if (idx == 0 and enc is not None
                and _layer0_fusible(cfg, enc, False, dev, training)):
            body, mode = layer0_body(lcfg)
            entries.append({
                "layer": name,
                "path": (path(KERNEL_IZH_L0, KERNEL_IZH_L0_BWD,
                              "fused_izh_layer0_reference", mode) if izh
                         else path(KERNEL_L0, KERNEL_L0_BWD,
                                   "fused_layer0_reference", mode)),
                "reason": "encoding + input product + scan in one call"
                          + also + body + gwin_note() + (gbits_note(
                              "g_W_rec", lcfg.output_size, md_size)
                              if rec_of(lcfg) else "") + where,
            })
            continue
        if (idx == 0 and enc is not None
                and _encode_matmul_fusible(cfg, enc, dev, training)):
            entries.append({
                "layer": name,
                "path": path(KERNEL_ENC, KERNEL_ENC_BWD,
                             "encode_matmul_reference"),
                "reason": "input currents of all steps from the latencies "
                          "in one call (no spike raster)" + also + where,
            })
        if idx > 0 and _mid_layer_fusible(cfg, lcfg, False, dev, training):
            body, mode = mid_body(layer_cfgs[idx - 1][1].output_size, lcfg,
                                  0)
            entries.append({
                "layer": name,
                "path": path(KERNEL_MID, KERNEL_MID_BWD,
                             "fused_mid_reference", mode),
                "reason": "input product inside the scan call (no currents "
                          "tensor)" + also + body + gbits_note(
                              "g_W_in and g_W_rec" if rec_of(lcfg)
                              else "g_W_in", lcfg.output_size, md_size)
                          + where,
            })
            continue
        if _layer_scan_fusible(cfg, lcfg, False, dev, training):
            gb, mode = "", ""
            if type(lcfg) is IzhikevichConfig:
                kernels = (KERNEL_IZH_SCAN, KERNEL_IZH_SCAN_BWD,
                           "izh_scan_reference")
                gb, mode = izh_scan_body(lcfg)
                if rec_of(lcfg):
                    # g_W_rec reads the chain's float32 g_i.
                    gb += gbits_note("g_W_rec", lcfg.output_size, 4)
            elif lcfg.use_recurrent_connection:
                kernels = (KERNEL_REC_TRAIN if training else KERNEL_REC,
                           KERNEL_REC_BWD, "rec_scan_reference")
                # rec_scan_bwd's g_W_rec reads the chain's float32 g_i.
                gb = gbits_note("g_W_rec", lcfg.output_size, 4)
                if on_card:
                    body, mode = rec_scan_body_note(
                        cfg.int_time_steps, lcfg.output_size, md_size, dev,
                        training)
                    gb = body + gb
            else:
                kernels = (KERNEL_SCAN_TRAIN if training else KERNEL_SCAN,
                           KERNEL_SCAN_BWD, "scan_reference")
            entries.append({
                "layer": name,
                "path": path(*kernels, mode=mode),
                "reason": "currents of all steps in one product, then the "
                          "scan in one call" + also + gb + where,
            })
            continue
        if type(lcfg) is ReadoutConfig and cfg.use_kernels:
            reason = "readout layer (consumed by prediction_logits)"
        else:
            reason = loop_reason
        entries.append({"layer": name, "path": "torch:loop",
                        "reason": reason})
    return entries


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
