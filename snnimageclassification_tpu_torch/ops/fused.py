"""Whole-network head: encode + LIF/ALIF scan + readout + max over time,
forward and backward.

Port of ``fused_encode_{rec,ff}_scan_head`` and their ``_counts`` variants
(JAX package, ops/pallas_fused.py).  For a single-hidden-layer classifier
one call computes the whole network from integer latencies: spike rows ->
``W_in`` -> (recurrent) LIF/ALIF scan -> readout ``v = kappa v + z @ W_out
+ b`` -> running max with strict ``>`` (the first maximal step wins, as
``torch.max``).  The ``_counts`` variants also return the per-sample spike
counts ``(B, H)``.

Three hand-written CUDA kernels stand behind the wrappers:

* ``fused_head_fwd`` (``csrc/fused_head.cu``): inference, only the logits
  leave.  Taken under ``torch.no_grad()`` or when no weight requires a
  gradient.
* ``fused_head_fwd_train`` (same source): the same arithmetic, bitwise
  equal logits, plus the residual ``delta = V' - thr`` (and the adaptation
  trace ``a`` for ALIF with the Phi surrogate) as ``(T, B, H)`` in the
  weights' dtype, the argmax step ``tstar (B, O)`` and the spike counts.
* ``fused_head_bwd`` (``csrc/fused_head_bwd.cu``): reverse-time
  surrogate-gradient BPTT from the cotangents of the logits (and counts) to
  ``g_W_in, g_W_rec, g_W_out, g_b``.  ``beta`` gets a zero cotangent (no
  gradient flows through the threshold, the reset or the adaptation).

Each wrapper picks its implementation from where the latencies lie: on a
CUDA device it launches the kernels or raises; on the CPU it runs the
plain PyTorch versions (``_head_reference``, ``_head_train_reference``,
``_head_bwd_reference``), which the tests hold against the JAX kernels.
The ``*_reference`` entry points run the plain versions on any device.

Matmul operands follow the weights' dtype (float32 or bfloat16) and every
sum accumulates in float32; ``b_out`` and ``beta`` are float32.  In the
backward ``s`` and ``dcur`` are rounded to the weights' dtype before each
product, and the gradients of the weights come back in the weights' dtype.
The recurrent weights must already be eye-masked
(``cells.masked_recurrent``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple, Union

import torch

from .encoding import spike_row
from .surrogate import SpikeFuncType, surrogate_grad_from_delta

__all__ = [
    "fused_encode_rec_scan_head",
    "fused_encode_ff_scan_head",
    "fused_encode_rec_scan_head_counts",
    "fused_encode_ff_scan_head_counts",
    "fused_encode_rec_scan_head_reference",
    "fused_encode_ff_scan_head_reference",
    "fused_encode_rec_scan_head_counts_reference",
    "fused_encode_ff_scan_head_counts_reference",
    "fused_head_supported",
    "launch_counts",
    "reset_launch_counts",
]

KERNEL = "fused_head_fwd"
KERNEL_TRAIN = "fused_head_fwd_train"
KERNEL_BWD = "fused_head_bwd"
MAX_STEPS = 32767  # the kernels stage latencies and steps as int16
_counts_lock = threading.Lock()
_launches = {KERNEL: 0, KERNEL_TRAIN: 0, KERNEL_BWD: 0}

Beta = Union[float, torch.Tensor]


def launch_counts() -> dict:
    """Kernel launches by kernel name since the last reset."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _launches:
            _launches[k] = 0


def _launched(kernel: str) -> None:
    with _counts_lock:
        _launches[kernel] += 1


def _stores_a(alif: bool, spike_func: SpikeFuncType) -> bool:
    """ALIF with Phi needs the adaptation trace for the dynamic-threshold
    scale of its surrogate; every other combination needs ``delta`` only."""
    return alif and spike_func == SpikeFuncType.Phi


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _head_loop(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods,
               alif, alpha, rho, threshold, kappa, train, store, store_a,
               want_counts):
    """Per-step loop with the kernels' arithmetic in the kernels' order.

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
    tstar = torch.zeros((B, O), dtype=torch.int32, device=dev)
    counts = torch.zeros_like(v) if train and want_counts else None
    deltas, a_trace = [], []
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
        delta = v - thr
        z = (delta >= 0).to(f32)
        v_r = kappa * v_r + (z @ w_out32 + b)
        better = v_r > m
        m = torch.where(better, v_r, m)
        if train:
            tstar = torch.where(better, torch.full_like(tstar, t), tstar)
            if counts is not None:
                counts = counts + z
            if store:
                deltas.append(delta.to(w_in.dtype))  # rounded once, here
                if store_a:
                    a_trace.append(a.to(w_in.dtype))
    if not train:
        return m
    return (m, torch.stack(deltas) if store else None,
            torch.stack(a_trace) if store and store_a else None, tstar,
            counts)


def _head_reference(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                    use_periods, alif, alpha, rho, threshold, kappa):
    """Plain version of ``fused_head_fwd``: logits only."""
    return _head_loop(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                      use_periods, alif, alpha, rho, threshold, kappa,
                      False, False, False, False)


def _head_train_reference(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                          use_periods, alif, alpha, rho, threshold, kappa,
                          store, store_a, want_counts):
    """Plain version of ``fused_head_fwd_train``: ``(logits, delta (T, B,
    H) | None, a (T, B, H) | None, tstar (B, O) int32, counts (B, H) |
    None)``; the traces in the weights' dtype."""
    return _head_loop(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                      use_periods, alif, alpha, rho, threshold, kappa,
                      True, store, store_a, want_counts)


def _head_bwd_reference(g_logits, g_counts, tstar, delta, a_tr, lat, w_in,
                        w_rec, beta, w_out, n_steps, use_periods, alpha,
                        threshold, gamma, kappa, spike_func):
    """Plain version of ``fused_head_bwd``: an explicit reverse-time loop
    from the residuals, rounding ``s`` and ``dcur`` through the weights'
    dtype before each product; ``(g_w_in, g_w_rec | None, g_w_out, g_b)``,
    the weights' gradients in the weights' dtype."""
    f32 = torch.float32
    dev = lat.device
    wd = w_out.dtype

    def r(x):
        return x if wd == f32 else x.to(wd).to(f32)

    w_out32 = w_out.to(f32)
    w_rec32 = None if w_rec is None else w_rec.to(f32)
    B, F = lat.shape
    H, O = w_out.shape
    g = g_logits.to(f32)
    beta_t = (torch.as_tensor(beta, dtype=f32, device=dev)
              if a_tr is not None else None)
    s = torch.zeros((B, O), dtype=f32, device=dev)
    dcur = torch.zeros((B, H), dtype=f32, device=dev)
    g_w_in = torch.zeros((F, H), dtype=f32, device=dev)
    g_w_rec = None if w_rec is None else torch.zeros((H, H), dtype=f32,
                                                     device=dev)
    g_w_out = torch.zeros((H, O), dtype=f32, device=dev)
    g_b = torch.zeros((O,), dtype=f32, device=dev)
    no_spikes = torch.zeros((B, H), dtype=f32, device=dev)
    for t in range(n_steps - 1, -1, -1):
        s = kappa * s + g * (tstar == t).to(f32)
        s_r = r(s)
        dz = s_r @ w_out32.T
        if g_counts is not None:
            dz = dz + g_counts
        if w_rec32 is not None:
            dz = dz + r(dcur) @ w_rec32.T
        d_t = delta[t].to(f32)
        thr = (threshold + beta_t * a_tr[t].to(f32) if a_tr is not None
               else threshold)
        surr = surrogate_grad_from_delta(spike_func, d_t, thr, gamma)
        dv = dz * surr + alpha * dcur
        z_prev = ((delta[t - 1].to(f32) >= 0).to(f32) if t > 0
                  else no_spikes)
        dcur = dv * (1.0 - z_prev)
        dcr = r(dcur)
        # Spike rows at the forward step index of the dcur row they meet.
        g_w_in += spike_row(lat, t, n_steps, use_periods).to(f32).T @ dcr
        if g_w_rec is not None:
            g_w_rec += z_prev.T @ dcr
        g_w_out += (d_t >= 0).to(f32).T @ s_r
        g_b += s.sum(0)
    return (g_w_in.to(w_in.dtype),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype),
            g_w_out.to(wd), g_b)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(name: str, lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    if name == "fused_head":
        lib.snn_fused_head_plan.argtypes = [i, i, i, i, i, i, ip, ip]
        lib.snn_fused_head_plan.restype = i
        lib.snn_fused_head_fwd.argtypes = (
            [vp] * 7 + [i] * 8 + [f] * 4 + [i, i, vp])
        lib.snn_fused_head_fwd.restype = i
        lib.snn_fused_head_fwd_train.argtypes = (
            [vp] * 11 + [i] * 8 + [f] * 4 + [i, i, vp])
        lib.snn_fused_head_fwd_train.restype = i
    else:
        lib.snn_fused_head_bwd_plan.argtypes = [i] * 9 + [ip]
        lib.snn_fused_head_bwd_plan.restype = i
        lib.snn_fused_head_bwd.argtypes = (
            [vp] * 14 + [i] * 8 + [f] * 4 + [i, vp])
        lib.snn_fused_head_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib(name: str = "fused_head") -> ctypes.CDLL:
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_snn_declared", False):
        _declare(name, lib)
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: {lib.snn_cuda_error_string(rc).decode()}")


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _plan(device: torch.device, F: int, H: int, O: int, recurrent: bool,
          bf16: bool) -> Optional[Tuple[int, int]]:
    """(rows per block, shared-memory bytes) of the forward kernels on
    ``device``, or None when the shape does not fit them."""
    lib = _lib()
    rows, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_fused_head_plan(F, H, O, int(recurrent), int(bf16),
                                 _index(device), ctypes.byref(rows),
                                 ctypes.byref(smem))
    if rc == 1:
        return None
    _raise_on(rc, lib, f"{KERNEL} plan")
    return rows.value, smem.value


def _plan_bwd(device: torch.device, B: int, F: int, H: int, O: int, T: int,
              recurrent: bool, bf16: bool,
              use_periods: bool) -> Optional[Tuple[int, int, int]]:
    """Blocks of (g_W_in, g_W_rec, g_W_out/g_b) partial slabs of the
    backward kernel on ``device``, or None when the shape does not fit."""
    lib = _lib("fused_head_bwd")
    out = (ctypes.c_int * 3)()
    rc = lib.snn_fused_head_bwd_plan(B, F, H, O, T, int(recurrent),
                                     int(bf16), int(use_periods),
                                     _index(device), out)
    if rc == 1:
        return None
    _raise_on(rc, lib, f"{KERNEL_BWD} plan")
    return out[0], out[1], out[2]


def fused_head_supported(
    n_steps: int, n_features: int, hidden: int, n_out: int,
    recurrent: bool = True, itemsize: int = 4, device="cuda",
    training: bool = False, use_periods: bool = True,
) -> bool:
    """Whether the head covers this shape on ``device``.

    On the CPU the plain versions cover every shape.  On a CUDA device the
    kernels need float32 or bfloat16 weights, ``hidden <= 1024`` (one
    thread per hidden unit), ``n_features <= 65535``,
    ``n_steps <= MAX_STEPS`` and the block's shared memory (``W_rec``,
    ``W_out`` and per-row state) within the device's opt-in limit.  With
    ``training`` the backward kernel must fit too: it stages one row's
    ``(n_steps, hidden)`` float32 table in shared memory (two with
    ``use_periods``).  Building the kernels to ask is part of their first
    use."""
    device = torch.device(device)
    if n_steps < 1 or n_out < 1 or hidden < 1 or n_features < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    if _plan(device, n_features, hidden, n_out, recurrent,
             itemsize == 2) is None:
        return False
    return not training or _plan_bwd(
        device, 1, n_features, hidden, n_out, n_steps, recurrent,
        itemsize == 2, use_periods) is not None


def _check(kernel, name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{kernel}: {name} must be {dtype} {shape} on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _beta_tensor(beta: Beta, dev: torch.device) -> torch.Tensor:
    if isinstance(beta, torch.Tensor):
        return beta.detach().to(dev, torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(beta), dtype=torch.float32, device=dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_forward(kernel, lat, w_in, w_rec, w_out, b_out, n_steps):
    """Validate the forward kernels' inputs; returns (B, F, H, O, rows)."""
    dev = lat.device
    B, F = lat.shape
    H, O = w_in.shape[1], w_out.shape[1]
    wdt = w_in.dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: weights must be float32 or bfloat16, "
                         f"got {wdt}")
    _check(kernel, "latencies", lat, torch.int32, (B, F), dev)
    _check(kernel, "w_in", w_in, wdt, (F, H), dev)
    if w_rec is not None:
        _check(kernel, "w_rec", w_rec, wdt, (H, H), dev)
    _check(kernel, "w_out", w_out, wdt, (H, O), dev)
    _check(kernel, "b_out", b_out, torch.float32, (O,), dev)
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{kernel}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    plan = _plan(dev, F, H, O, w_rec is not None, wdt == torch.bfloat16)
    if plan is None:
        raise ValueError(
            f"{kernel}: shape F={F} H={H} O={O} does not fit the kernel "
            "(gate on fused_head_supported)")
    return B, F, H, O, plan[0]


def _head_cuda(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods,
               alif, alpha, rho, threshold, kappa):
    """Launch ``fused_head_fwd``."""
    dev = lat.device
    B, F, H, O, rows = _check_forward(KERNEL, lat, w_in, w_rec, w_out,
                                      b_out, n_steps)
    beta_t = _beta_tensor(beta, dev)
    logits = torch.empty((B, O), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.snn_fused_head_fwd(
        lat.data_ptr(), w_in.data_ptr(), _ptr(w_rec), beta_t.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), logits.data_ptr(), B, F, H, O,
        n_steps, int(use_periods), int(alif),
        int(w_in.dtype == torch.bfloat16), alpha, rho, threshold, kappa,
        rows, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{KERNEL} launch")
    _launched(KERNEL)
    return logits


def _head_train_cuda(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                     use_periods, alif, alpha, rho, threshold, kappa, store,
                     store_a, want_counts):
    """Launch ``fused_head_fwd_train``; returns as
    :func:`_head_train_reference`."""
    dev = lat.device
    B, F, H, O, rows = _check_forward(KERNEL_TRAIN, lat, w_in, w_rec, w_out,
                                      b_out, n_steps)
    beta_t = _beta_tensor(beta, dev)
    logits = torch.empty((B, O), dtype=torch.float32, device=dev)
    tstar = torch.empty((B, O), dtype=torch.int32, device=dev)
    trace = dict(dtype=w_in.dtype, device=dev)
    delta = torch.empty((n_steps, B, H), **trace) if store else None
    a_tr = torch.empty((n_steps, B, H), **trace) if store and store_a \
        else None
    counts = torch.empty((B, H), dtype=torch.float32, device=dev) \
        if want_counts else None
    lib = _lib()
    rc = lib.snn_fused_head_fwd_train(
        lat.data_ptr(), w_in.data_ptr(), _ptr(w_rec), beta_t.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), logits.data_ptr(), _ptr(delta),
        _ptr(a_tr), tstar.data_ptr(), _ptr(counts), B, F, H, O, n_steps,
        int(use_periods), int(alif), int(w_in.dtype == torch.bfloat16),
        alpha, rho, threshold, kappa, rows, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{KERNEL_TRAIN} launch")
    _launched(KERNEL_TRAIN)
    return logits, delta, a_tr, tstar, counts


def _head_bwd_cuda(g_logits, g_counts, tstar, delta, a_tr, lat, w_in, w_rec,
                   beta, w_out, n_steps, use_periods, alpha, threshold,
                   gamma, kappa, spike_func):
    """Launch ``fused_head_bwd`` (its four ``__global__`` functions in one
    call) and add the blocks' partial slabs in a fixed order."""
    dev = lat.device
    B, F = lat.shape
    H, O = w_out.shape
    wdt = w_out.dtype
    k = KERNEL_BWD
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{k}: weights must be float32 or bfloat16, "
                         f"got {wdt}")
    _check(k, "g_logits", g_logits, torch.float32, (B, O), dev)
    _check(k, "tstar", tstar, torch.int32, (B, O), dev)
    if g_counts is not None:
        _check(k, "g_counts", g_counts, torch.float32, (B, H), dev)
    _check(k, "delta", delta, wdt, (n_steps, B, H), dev)
    if a_tr is not None:
        _check(k, "a", a_tr, wdt, (n_steps, B, H), dev)
    _check(k, "latencies", lat, torch.int32, (B, F), dev)
    if w_rec is not None:
        _check(k, "w_rec", w_rec, wdt, (H, H), dev)
    _check(k, "w_out", w_out, wdt, (H, O), dev)
    bf16 = wdt == torch.bfloat16
    plan = _plan_bwd(dev, B, F, H, O, n_steps, w_rec is not None, bf16,
                     use_periods)
    if plan is None:
        raise ValueError(
            f"{k}: shape T={n_steps} F={F} H={H} O={O} does not fit the "
            "kernel (gate on fused_head_supported(training=True))")
    n_in, n_rec, n_out = plan
    f32 = dict(dtype=torch.float32, device=dev)
    # Scratch of the call: dcur(t) per row and the bits of z per row.
    dcur = torch.empty((B, n_steps, H), dtype=wdt, device=dev)
    zmask = torch.empty((B, n_steps + 1, (H + 31) // 32), dtype=torch.int32,
                        device=dev)
    slab_in = torch.empty((n_in, F * H), **f32)
    slab_rec = torch.empty((n_rec, H * H), **f32)
    slab_out = torch.empty((n_out, H * O + O), **f32)
    lib = _lib("fused_head_bwd")
    rc = lib.snn_fused_head_bwd(
        g_logits.data_ptr(), tstar.data_ptr(), _ptr(g_counts),
        delta.data_ptr(), _ptr(a_tr), lat.data_ptr(), _ptr(w_rec),
        w_out.data_ptr(), _beta_tensor(beta, dev).data_ptr(),
        dcur.data_ptr(), zmask.data_ptr(), slab_in.data_ptr(),
        slab_rec.data_ptr(), slab_out.data_ptr(), B, F, H, O, n_steps,
        int(use_periods), int(spike_func == SpikeFuncType.Phi), int(bf16),
        alpha, threshold, gamma, kappa, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    # The sum over the blocks' slabs lies outside the TPU kernel too.
    g_w_in = slab_in.sum(0).view(F, H).to(w_in.dtype)
    g_w_rec = (None if w_rec is None
               else slab_rec.sum(0).view(H, H).to(wdt))
    out_sum = slab_out.sum(0)
    g_w_out = out_sum[:H * O].view(H, O).to(wdt)
    return g_w_in, g_w_rec, g_w_out, out_sum[H * O:].clone()


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
def _impl(lat: torch.Tensor, plain: bool) -> str:
    if plain or lat.device.type == "cpu":
        return "plain"
    if lat.device.type == "cuda":
        return "cuda"
    raise ValueError(f"{KERNEL}: no implementation for device {lat.device}")


class _HeadFn(torch.autograd.Function):
    """The head with its backward: the training forward saves the
    residuals, the backward runs the reverse-time kernel (or, for CPU
    tensors, its plain version)."""

    @staticmethod
    def forward(ctx, lat, w_in, w_rec, beta, w_out, b_out, statics,
                want_counts, plain):
        (n_steps, use_periods, alif, alpha, rho, threshold, gamma, kappa,
         spike_func) = statics
        impl = _impl(lat, plain)
        fwd = _head_train_cuda if impl == "cuda" else _head_train_reference
        logits, delta, a_tr, tstar, counts = fwd(
            lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
            alpha, rho, threshold, kappa, True, _stores_a(alif, spike_func),
            want_counts)
        ctx.impl, ctx.statics = impl, statics
        ctx.beta = beta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(lat, w_in, w_rec, w_out, delta, a_tr, tstar)
        if want_counts:
            return logits, counts
        return logits

    @staticmethod
    def backward(ctx, g_logits, g_counts=None):
        lat, w_in, w_rec, w_out, delta, a_tr, tstar = ctx.saved_tensors
        (n_steps, use_periods, _, alpha, _, threshold, gamma, kappa,
         spike_func) = ctx.statics
        if g_logits is None:
            g_logits = torch.zeros(tstar.shape, dtype=torch.float32,
                                   device=lat.device)
        g_logits = g_logits.to(torch.float32).contiguous()
        if g_counts is not None:
            g_counts = g_counts.to(torch.float32).contiguous()
        bwd = _head_bwd_cuda if ctx.impl == "cuda" else _head_bwd_reference
        g_w_in, g_w_rec, g_w_out, g_b = bwd(
            g_logits, g_counts, tstar, delta, a_tr, lat, w_in, w_rec,
            ctx.beta, w_out, n_steps, use_periods, alpha, threshold, gamma,
            kappa, spike_func)
        # No gradient reaches beta: it enters only through the threshold.
        g_beta = (torch.zeros_like(ctx.beta)
                  if isinstance(ctx.beta, torch.Tensor)
                  and ctx.beta.requires_grad else None)
        return (None, g_w_in, g_w_rec, g_beta, g_w_out, g_b, None, None,
                None)


def _head(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
          alpha, rho, threshold, gamma, kappa, spike_func, want_counts,
          plain=False):
    scalars = (int(n_steps), bool(use_periods), bool(alif), float(alpha),
               float(rho), float(threshold))
    kappa = float(kappa)
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    needs_grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (w_in, w_rec, beta, w_out, b_out))
    if needs_grad:
        statics = (*scalars, float(gamma), kappa, spike_func)
        return _HeadFn.apply(lat, w_in, w_rec, beta, w_out, b_out, statics,
                             want_counts, plain)
    cuda = _impl(lat, plain) == "cuda"
    args = (lat, w_in, w_rec, beta, w_out, b_out, *scalars, kappa)
    if not want_counts:  # inference: no residual leaves the kernel
        return (_head_cuda if cuda else _head_reference)(*args)
    fwd = _head_train_cuda if cuda else _head_train_reference
    logits, _, _, _, counts = fwd(*args, False, False, True)
    return logits, counts


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
    gamma: float,
    kappa: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """(latencies (B, F) int32, W_in, masked W_rec, ...) -> logits (B, O),
    differentiable in the weights and the bias.

    For LIF pass ``alif=False`` (``beta`` and ``rho`` are ignored).
    ``gamma`` and ``spike_func`` shape the surrogate gradient only."""
    return _head(latencies, w_in, w_rec, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, False)


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
    gamma: float,
    kappa: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Feedforward variant: no recurrent weights."""
    return _head(latencies, w_in, None, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, False)


def fused_encode_rec_scan_head_counts(
    latencies, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
    alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`fused_encode_rec_scan_head` but returns ``(logits (B,
    O), spike_counts (B, H))`` with ``spike_counts[b, h] = sum_t z_t[b,
    h]`` (float32, exact integers); differentiable in both outputs."""
    return _head(latencies, w_in, w_rec, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, True)


def fused_encode_ff_scan_head_counts(
    latencies, w_in, beta, w_out, b_out, n_steps, use_periods, alif, alpha,
    rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feedforward head + counts variant."""
    return _head(latencies, w_in, None, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, True)


def fused_encode_rec_scan_head_reference(
    latencies, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
    alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """:func:`fused_encode_rec_scan_head` through the plain PyTorch
    versions, forward and backward, on whatever device the tensors lie."""
    return _head(latencies, w_in, w_rec, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, False, plain=True)


def fused_encode_ff_scan_head_reference(
    latencies, w_in, beta, w_out, b_out, n_steps, use_periods, alif, alpha,
    rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encode_ff_scan_head`."""
    return _head(latencies, w_in, None, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, False, plain=True)


def fused_encode_rec_scan_head_counts_reference(
    latencies, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
    alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_encode_rec_scan_head_counts`."""
    return _head(latencies, w_in, w_rec, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, True, plain=True)


def fused_encode_ff_scan_head_counts_reference(
    latencies, w_in, beta, w_out, b_out, n_steps, use_periods, alif, alpha,
    rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_encode_ff_scan_head_counts`."""
    return _head(latencies, w_in, None, beta, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, gamma, kappa,
                 spike_func, True, plain=True)
