"""Feedforward LIF/ALIF scan over precomputed input currents, forward and
backward.

Port of the JAX package's ops/pallas_scan.py: ``alif_scan(currents (T, B,
H) float32, beta, ...)`` and ``lif_scan`` -> spikes ``(T, B, H)`` in
``trace_dtype``, differentiable in the currents.  A feedforward layer whose
currents come from a product (raster or constant-pixel input, an encoding
shorter than the simulation, a layer no fused kernel takes) scans them in
one call (models/snn.py:apply).

Dynamics (``z(-1) = 0``, ``v = a = 0`` before step 0):

    v    = (alpha v + i(t))(1 - z(t-1))
    ALIF: a = rho a + z(t-1), thr = threshold + beta a
    z(t) = [v - thr >= 0]

Training keeps the residuals of the JAX kernel in ``trace_dtype``: ``z``
and ``delta = v - thr`` (ALIF with FastSigmoid), else ``z`` and ``v`` (and
``a`` for ALIF with Phi).  The backward (``pallas_scan.py:22-29``):

    dv   = g_z(t) surr(delta(t)) + carry
    g_i(t) = dv (1 - z(t-1)),  carry = alpha g_i(t)      (float32)

``beta`` gets a zero cotangent (quirk Q3).

Two hand-written CUDA kernels stand behind the wrappers (``csrc/scan.cu``):
``scan_fwd`` (inference: ``z`` only) / ``scan_fwd_train`` (the same
arithmetic, plus the residuals), and ``scan_bwd``.  On a CUDA tensor a
wrapper launches them or raises; on the CPU it runs the plain PyTorch
versions (``_fwd_reference``, ``_bwd_reference``), which the tests hold
against the JAX kernels.  The ``*_reference`` entry points run the plain
versions on any device.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import fused as _f
from .fused import KERNEL_SCAN, KERNEL_SCAN_BWD, KERNEL_SCAN_TRAIN, Beta
from .surrogate import SpikeFuncType, surrogate_grad_from_delta

__all__ = [
    "alif_scan",
    "lif_scan",
    "alif_scan_reference",
    "lif_scan_reference",
    "scan_supported",
]

TraceDtype = Union[str, torch.dtype]


def _trace_dtype(trace_dtype: TraceDtype) -> torch.dtype:
    dt = (getattr(torch, trace_dtype, None) if isinstance(trace_dtype, str)
          else trace_dtype)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"trace_dtype must be float32 or bfloat16, got "
                         f"{trace_dtype!r}")
    return dt


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _fwd_reference(currents, beta, alif, alpha, rho, threshold, train,
                   store_a, res_is_v, trace_dtype):
    """Plain version of ``scan_fwd[_train]``: ``(z, res | None, a | None)``
    in ``trace_dtype``; ``res`` is ``v`` or ``delta``."""
    T, B, H = currents.shape
    cell = _f._Cell(B, H, currents.device, None, beta, alif, False)
    zs, res, a_tr = [], [], []
    for t in range(T):
        delta = cell.step(currents[t], alpha, rho, threshold)
        zs.append(cell.z.to(trace_dtype))
        if train:
            res.append((cell.v if res_is_v else delta).to(trace_dtype))
            if store_a:
                a_tr.append(cell.a.to(trace_dtype))
    return (torch.stack(zs), torch.stack(res) if train else None,
            torch.stack(a_tr) if train and store_a else None)


def _bwd_reference(g_z, z, res, a_tr, res_is_v, beta, alpha, threshold,
                   gamma, spike_func):
    """Plain version of ``scan_bwd``: ``g_i (T, B, H)`` float32."""
    f32 = torch.float32
    T, B, H = res.shape
    dev = res.device
    beta_t = (torch.as_tensor(beta, dtype=f32, device=dev)
              if a_tr is not None else None)
    carry = torch.zeros((B, H), dtype=f32, device=dev)
    g_i = [None] * T
    for t in range(T - 1, -1, -1):
        thr = (threshold + beta_t * a_tr[t].to(f32) if a_tr is not None
               else threshold)
        d_t = res[t].to(f32) - thr if res_is_v else res[t].to(f32)
        surr = surrogate_grad_from_delta(spike_func, d_t, thr, gamma)
        dv = g_z[t].to(f32) * surr + carry
        z_prev = (z[t - 1].to(f32) if t > 0
                  else torch.zeros((B, H), dtype=f32, device=dev))
        g_i[t] = dv * (1.0 - z_prev)
        carry = alpha * g_i[t]
    return torch.stack(g_i)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.snn_scan_fwd.argtypes = [vp] * 3 + [i] * 5 + [f] * 3 + [i, vp]
    lib.snn_scan_fwd.restype = i
    lib.snn_scan_fwd_train.argtypes = [vp] * 5 + [i] * 6 + [f] * 3 + [i, vp]
    lib.snn_scan_fwd_train.restype = i
    lib.snn_scan_bwd.argtypes = [vp] * 6 + [i] * 6 + [f] * 3 + [i, vp]
    lib.snn_scan_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("scan")
    if not getattr(lib, "_snn_declared", False):
        _declare(lib)
    return lib


def scan_supported(n_steps: int, hidden: int, *, itemsize: int = 4,
                   device="cuda", training: bool = False) -> bool:
    """Whether the feedforward scan covers this shape on ``device``.  Every
    lane is independent, so the kernels hold no shape limit beyond the
    grid's; on a CUDA device the traces must be float32 or bfloat16."""
    del training  # the three kernels take the same shapes
    device = torch.device(device)
    if n_steps < 1 or hidden < 1:
        return False
    if device.type == "cpu":
        return True
    return device.type == "cuda" and itemsize in (2, 4)


def _fwd_cuda(currents, beta, alif, alpha, rho, threshold, train, store_a,
              res_is_v, trace_dtype):
    """Launch ``scan_fwd`` (``scan_fwd_train`` with ``train``); returns as
    :func:`_fwd_reference`."""
    k = KERNEL_SCAN_TRAIN if train else KERNEL_SCAN
    dev = currents.device
    T, B, H = currents.shape
    _f._check(k, "currents", currents, torch.float32, (T, B, H), dev)
    trace = dict(dtype=trace_dtype, device=dev)
    z = torch.empty((T, B, H), **trace)
    res = torch.empty((T, B, H), **trace) if train else None
    a_tr = torch.empty((T, B, H), **trace) if train and store_a else None
    beta_t = _f._beta_tensor(beta, dev)  # held until the launch
    bf16 = int(trace_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if train:
        rc = lib.snn_scan_fwd_train(
            currents.data_ptr(), beta_t.data_ptr(), z.data_ptr(),
            res.data_ptr(), _f._ptr(a_tr), B, H, T, int(alif), bf16,
            int(res_is_v), alpha, rho, threshold, _f._index(dev), stream)
    else:
        rc = lib.snn_scan_fwd(
            currents.data_ptr(), beta_t.data_ptr(), z.data_ptr(), B, H, T,
            int(alif), bf16, alpha, rho, threshold, _f._index(dev), stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return z, res, a_tr


def _bwd_cuda(g_z, z, res, a_tr, res_is_v, beta, alpha, threshold, gamma,
              spike_func):
    """Launch ``scan_bwd``; returns ``g_i (T, B, H)`` float32."""
    k = KERNEL_SCAN_BWD
    dev = res.device
    T, B, H = res.shape
    tdt = res.dtype
    if tdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{k}: traces must be float32 or bfloat16, got "
                         f"{tdt}")
    for name, t in (("g_z", g_z), ("z", z), ("res", res), ("a", a_tr)):
        if t is not None:
            _f._check(k, name, t, tdt, (T, B, H), dev)
    g_i = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    beta_t = _f._beta_tensor(beta, dev)
    lib = _lib()
    rc = lib.snn_scan_bwd(
        g_z.data_ptr(), z.data_ptr(), res.data_ptr(), _f._ptr(a_tr),
        beta_t.data_ptr(), g_i.data_ptr(), B, H, T,
        int(spike_func == SpikeFuncType.Phi), int(tdt == torch.bfloat16),
        int(res_is_v), alpha, threshold, gamma, _f._index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return g_i


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _ScanFn(torch.autograd.Function):
    """The scan with its backward: the training forward keeps ``z`` and
    the residuals."""

    @staticmethod
    def forward(ctx, currents, beta, statics, plain):
        alif, alpha, rho, threshold, gamma, spike_func, tdt = statics
        impl = _f._impl(currents, plain)
        fwd = _fwd_cuda if impl == "cuda" else _fwd_reference
        res_is_v = _f._residual_is_v(alif, spike_func)
        z, res, a_tr = fwd(currents, beta, alif, alpha, rho, threshold, True,
                           _f._stores_a(alif, spike_func), res_is_v, tdt)
        ctx.impl, ctx.statics, ctx.beta, ctx.res_is_v = (impl, statics, beta,
                                                         res_is_v)
        ctx.save_for_backward(z, res, a_tr)
        return z

    @staticmethod
    def backward(ctx, g_z):
        z, res, a_tr = ctx.saved_tensors
        _, alpha, _, threshold, gamma, spike_func, _ = ctx.statics
        bwd = _bwd_cuda if ctx.impl == "cuda" else _bwd_reference
        g_i = bwd(g_z.to(z.dtype).contiguous(), z, res, a_tr, ctx.res_is_v,
                  ctx.beta, alpha, threshold, gamma, spike_func)
        return g_i, _f._zero_beta_grad(ctx.beta), None, None


def _scan(currents, beta, alif, alpha, rho, threshold, gamma, spike_func,
          trace_dtype, plain=False):
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    currents = currents.to(torch.float32).contiguous()
    statics = (bool(alif), float(alpha), float(rho), float(threshold),
               float(gamma), spike_func, _trace_dtype(trace_dtype))
    if _f._wants_grad(currents, beta):
        return _ScanFn.apply(currents, beta, statics, plain)
    fwd = (_fwd_cuda if _f._impl(currents, plain) == "cuda"
           else _fwd_reference)
    # Inference: only the spike trace leaves.
    return fwd(currents, beta, *statics[:4], False, False, False,
               statics[6])[0]


def alif_scan(currents: torch.Tensor, beta: Beta, alpha: float, rho: float,
              threshold: float, gamma: float,
              spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
              trace_dtype: TraceDtype = "float32") -> torch.Tensor:
    """Feedforward ALIF: currents ``(T, B, H)`` float32 -> spikes ``(T, B,
    H)`` in ``trace_dtype`` (float32 or bfloat16: the residuals are stored
    in it too), differentiable in the currents.  ``beta`` may be a tensor
    (``learn_beta``); its gradient is zero."""
    return _scan(currents, beta, True, alpha, rho, threshold, gamma,
                 spike_func, trace_dtype)


def lif_scan(currents: torch.Tensor, alpha: float, threshold: float,
             gamma: float,
             spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
             trace_dtype: TraceDtype = "float32") -> torch.Tensor:
    """Feedforward LIF: as :func:`alif_scan` without adaptation."""
    return _scan(currents, 0.0, False, alpha, 0.0, threshold, gamma,
                 spike_func, trace_dtype)


def alif_scan_reference(currents, beta, alpha, rho, threshold, gamma,
                        spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
                        trace_dtype: TraceDtype = "float32") -> torch.Tensor:
    """:func:`alif_scan` through the plain PyTorch versions, forward and
    backward, on whatever device the tensors lie."""
    return _scan(currents, beta, True, alpha, rho, threshold, gamma,
                 spike_func, trace_dtype, plain=True)


def lif_scan_reference(currents, alpha, threshold, gamma,
                       spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
                       trace_dtype: TraceDtype = "float32") -> torch.Tensor:
    """Plain PyTorch version of :func:`lif_scan`."""
    return _scan(currents, 0.0, False, alpha, 0.0, threshold, gamma,
                 spike_func, trace_dtype, plain=True)
