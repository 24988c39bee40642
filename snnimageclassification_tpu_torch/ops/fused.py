"""Whole-network head: encode + LIF/ALIF scan + readout + max over time.

Port of the inference primal of ``fused_encode_rec_scan_head`` /
``fused_encode_ff_scan_head`` (JAX package, ops/pallas_fused.py).  For a
single-hidden-layer classifier one call computes the whole network from
integer latencies: spike rows -> ``W_in`` -> (recurrent) LIF/ALIF scan ->
readout ``v = kappa v + z @ W_out + b`` -> running max with strict ``>``
(the first maximal step wins, as ``torch.max``).  Only the logits leave.

Each wrapper picks its implementation from where the latencies lie: on a
CUDA device it launches the hand-written kernel (``csrc/fused_head.cu``)
or raises; on the CPU it runs the plain PyTorch version
(``*_reference``), which the tests hold against the JAX kernel.  Forward
only: the backward kernels come with the training path.

Matmul operands follow the weights' dtype (float32 or bfloat16) and every
sum accumulates in float32; ``b_out`` and ``beta`` are float32.  The
recurrent weights must already be eye-masked (``cells.masked_recurrent``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple, Union

import torch

from .encoding import spike_row

__all__ = [
    "fused_encode_rec_scan_head",
    "fused_encode_ff_scan_head",
    "fused_encode_rec_scan_head_reference",
    "fused_encode_ff_scan_head_reference",
    "fused_head_supported",
    "launch_counts",
    "reset_launch_counts",
]

KERNEL = "fused_head_fwd"
MAX_STEPS = 32767  # the kernel stages latencies as int16 clamped to [-1, T]
_counts_lock = threading.Lock()
_launches = {KERNEL: 0}

Beta = Union[float, torch.Tensor]


def launch_counts() -> dict:
    """Kernel launches by kernel name since the last reset."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _launches:
            _launches[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------
def _head_reference(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                    use_periods, alif, alpha, rho, threshold, kappa):
    """Per-step loop with the kernel's arithmetic in the kernel's order.

    bf16 weights are upcast to float32 (exact), so every product with a
    0/1 spike is exact and every sum is float32.  On a CUDA device, run it
    with ``torch.backends.cuda.matmul.allow_tf32 = False``: TF32 would
    round float32 weights."""
    f32 = torch.float32
    dev = lat.device
    w_in32, w_out32 = w_in.to(f32), w_out.to(f32)
    w_rec32 = None if w_rec is None else w_rec.to(f32)
    b = b_out.to(f32)
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev) if alif else None
    B, H, O = lat.shape[0], w_in.shape[1], w_out.shape[1]
    v = torch.zeros((B, H), dtype=f32, device=dev)
    a = torch.zeros_like(v)
    z = torch.zeros_like(v)
    v_r = torch.zeros((B, O), dtype=f32, device=dev)
    m = torch.full((B, O), float("-inf"), dtype=f32, device=dev)
    for t in range(n_steps):
        cur = spike_row(lat, t, n_steps, use_periods).to(f32) @ w_in32
        if w_rec32 is not None:
            cur = cur + z @ w_rec32
        v = (alpha * v + cur) * (1.0 - z)
        if alif:
            a = rho * a + z
            thr = threshold + beta_t * a
        else:
            thr = threshold
        z = (v - thr >= 0).to(f32)
        v_r = kappa * v_r + (z @ w_out32 + b)
        m = torch.where(v_r > m, v_r, m)
    return m


def fused_encode_rec_scan_head_reference(
    latencies, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
    alpha, rho, threshold, kappa,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encode_rec_scan_head`."""
    return _head_reference(latencies, w_in, w_rec, beta, w_out, b_out,
                           n_steps, use_periods, alif, alpha, rho, threshold,
                           kappa)


def fused_encode_ff_scan_head_reference(
    latencies, w_in, beta, w_out, b_out, n_steps, use_periods, alif, alpha,
    rho, threshold, kappa,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encode_ff_scan_head`."""
    return _head_reference(latencies, w_in, None, beta, w_out, b_out,
                           n_steps, use_periods, alif, alpha, rho, threshold,
                           kappa)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("fused_head")
    if not getattr(lib, "_snn_declared", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.snn_fused_head_plan.argtypes = [
            i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.snn_fused_head_plan.restype = i
        lib.snn_fused_head_fwd.argtypes = (
            [vp] * 7 + [i] * 8 + [f] * 4 + [i, i, vp])
        lib.snn_fused_head_fwd.restype = i
        lib.snn_cuda_error_string.argtypes = [i]
        lib.snn_cuda_error_string.restype = ctypes.c_char_p
        lib._snn_declared = True
    return lib


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _plan(device: torch.device, F: int, H: int, O: int, recurrent: bool,
          bf16: bool) -> Optional[Tuple[int, int]]:
    """(rows per block, shared-memory bytes) on ``device``, or None when
    the shape does not fit the kernel."""
    lib = _lib()
    rows, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_fused_head_plan(F, H, O, int(recurrent), int(bf16),
                                 _index(device), ctypes.byref(rows),
                                 ctypes.byref(smem))
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL} plan: {lib.snn_cuda_error_string(rc).decode()}")
    return rows.value, smem.value


def fused_head_supported(
    n_steps: int, n_features: int, hidden: int, n_out: int,
    recurrent: bool = True, itemsize: int = 4, device="cuda",
) -> bool:
    """Whether the head covers this shape on ``device``.

    On the CPU the plain version covers every shape.  On a CUDA device the
    kernel needs float32 or bfloat16 weights, ``hidden <= 1024`` (one
    thread per hidden unit), ``n_features <= 65535``,
    ``n_steps <= MAX_STEPS`` and the block's
    shared memory (``W_rec``, ``W_out`` and per-row state) within the
    device's opt-in limit.  Building the kernel to ask is part of its
    first use."""
    device = torch.device(device)
    if n_steps < 1 or n_out < 1 or hidden < 1 or n_features < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    return _plan(device, n_features, hidden, n_out, recurrent,
                 itemsize == 2) is not None


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{KERNEL}: {name} must be {dtype} {shape} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be contiguous")


def _head_cuda(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods,
               alif, alpha, rho, threshold, kappa):
    dev = lat.device
    B, F = lat.shape
    H, O = w_in.shape[1], w_out.shape[1]
    wdt = w_in.dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{KERNEL}: weights must be float32 or bfloat16, "
                         f"got {wdt}")
    _check("latencies", lat, torch.int32, (B, F), dev)
    _check("w_in", w_in, wdt, (F, H), dev)
    if w_rec is not None:
        _check("w_rec", w_rec, wdt, (H, H), dev)
    _check("w_out", w_out, wdt, (H, O), dev)
    _check("b_out", b_out, torch.float32, (O,), dev)
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{KERNEL}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    plan = _plan(dev, F, H, O, w_rec is not None, wdt == torch.bfloat16)
    if plan is None:
        raise ValueError(
            f"{KERNEL}: shape F={F} H={H} O={O} does not fit the kernel "
            "(gate on fused_head_supported)")
    rows, _ = plan
    if isinstance(beta, torch.Tensor):
        beta_t = beta.detach().to(dev, torch.float32).reshape(1).contiguous()
    else:
        beta_t = torch.full((1,), float(beta), dtype=torch.float32,
                            device=dev)
    logits = torch.empty((B, O), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.snn_fused_head_fwd(
        lat.data_ptr(), w_in.data_ptr(),
        None if w_rec is None else w_rec.data_ptr(),
        beta_t.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        logits.data_ptr(), B, F, H, O, n_steps, int(use_periods),
        int(alif), int(wdt == torch.bfloat16), alpha, rho, threshold,
        kappa, rows, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {lib.snn_cuda_error_string(rc).decode()}")
    with _counts_lock:
        _launches[KERNEL] += 1
    return logits


def _head(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
          alpha, rho, threshold, kappa):
    args = (lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods,
            alif, float(alpha), float(rho), float(threshold), float(kappa))
    if lat.device.type == "cuda":
        return _head_cuda(*args)
    if lat.device.type == "cpu":
        return _head_reference(*args)
    raise ValueError(f"{KERNEL}: no implementation for device {lat.device}")


def fused_encode_rec_scan_head(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: torch.Tensor,
    beta: Beta,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    n_steps: int,
    use_periods: bool,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    kappa: float,
) -> torch.Tensor:
    """(latencies (B, F) int32, W_in, masked W_rec, ...) -> logits (B, O).

    For LIF pass ``alif=False`` (``beta`` and ``rho`` are ignored)."""
    return _head(latencies, w_in, w_rec, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, kappa)


def fused_encode_ff_scan_head(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    beta: Beta,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    n_steps: int,
    use_periods: bool,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    kappa: float,
) -> torch.Tensor:
    """Feedforward variant: no recurrent weights."""
    return _head(latencies, w_in, None, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, kappa)
