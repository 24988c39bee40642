"""Spike encoding fused into the input-current product, forward and
backward.

Port of the JAX package's ops/pallas_encode.py: ``encoded_input_matmul(
latencies (B, F) int32, W (F, H), n_steps, use_periods) -> currents (T, B,
H) float32`` with ``currents[t] = spikes(t) @ W``, the spikes generated
from the integer latencies, so the ``(T, B, F)`` raster never exists.  A
first layer that no whole-layer kernel takes (a recurrent layer too wide
for the fused kernels' shared memory) gets its currents here, then one scan
call (models/snn.py:apply_pixels).

Encoding (ops/encoding.py, reference datasets.py:72-86):

* TTFS: a spike at ``t == latency`` (a latency >= n_steps never fires);
* periodic: ``p = clip(latency, 1, n_steps - 1)``, a spike where ``t - p
  >= 0`` and ``(t - p) % p == 0``.

Backward: ``g_W = sum_t spikes(t)^T g(t)``, accumulated in float32 and
cast to W's dtype; the latencies are integers and get no gradient.

Two hand-written CUDA kernels stand behind the wrapper
(``csrc/encode_matmul.cu``): ``encode_matmul_fwd`` and
``encode_matmul_bwd``.  On a CUDA tensor the wrapper launches them or
raises; on the CPU it runs the plain PyTorch versions
(``_fwd_reference``, ``_bwd_reference``), which the tests hold against the
JAX kernel.  :func:`encoded_input_matmul_reference` runs the plain
versions on any device.  W may be float32 or bfloat16; the products with
0/1 spikes are exact and every sum is float32.

The forward kernel adds W's rows by key (the TTFS step or the periodic
period) and, periodic, each step's divisors' sums in ascending period;
``_fwd_ordered_reference`` repeats that order in plain PyTorch, a bitwise
witness for the card that nothing on the main path calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused as _f
from .encoding import spike_row
from .fused import KERNEL_ENC, KERNEL_ENC_BWD, MAX_STEPS

__all__ = [
    "encoded_input_matmul",
    "encoded_input_matmul_reference",
    "encode_matmul_supported",
]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _fwd_reference(lat, w, n_steps, use_periods):
    """Plain version of ``encode_matmul_fwd``: ``(T, B, H)`` float32."""
    w32 = w.to(torch.float32)
    return torch.stack([
        spike_row(lat, t, n_steps, use_periods).to(torch.float32) @ w32
        for t in range(n_steps)])


def _fwd_ordered_reference(lat, w, n_steps, use_periods):
    """The forward in ``encode_matmul_fwd``'s order: ``(T, B, H)`` float32,
    equal to the kernel bit for bit.  Each feature's key is its TTFS step
    (T, a slot no step reads, where it never fires) or its periodic
    period ``clamp(L, 1, T - 1)`` (0 at T = 1).  W's rows are added in ascending f
    into ``acc[row, key]``, one float32 rounding an add; TTFS currents(t) is
    ``acc[:, t]``, periodic currents(t) the sum of ``acc[:, p]`` over the
    periods p that divide t (t >= p), added in ascending p (at T = 1,
    currents(0) = ``acc[:, 0]``)."""
    T = n_steps
    B, H = lat.shape[0], w.shape[1]
    w32 = w.to(torch.float32)
    if use_periods:
        key = torch.clamp(lat, 1, T - 1)
    else:
        key = torch.where((lat >= 0) & (lat < T), lat, T)
    key = key.long()
    acc = torch.zeros((B, T + 1, H), dtype=torch.float32, device=lat.device)
    rows = torch.arange(B, device=lat.device)
    for f in range(lat.shape[1]):
        acc[rows, key[:, f]] += w32[f]
    if not use_periods:
        return acc[:, :T].transpose(0, 1).contiguous()
    out = torch.zeros((T, B, H), dtype=torch.float32, device=lat.device)
    if T == 1:
        out[0] += acc[:, 0]
    for p in range(1, T):
        for t in range(p, T, p):
            out[t] += acc[:, p]
    return out


def _bwd_reference(lat, g, w_dtype, n_steps, use_periods):
    """Plain version of ``encode_matmul_bwd``: ``g_W (F, H)`` in W's
    dtype, summed over the steps in float32."""
    g_w = None
    for t in range(n_steps):
        part = spike_row(lat, t, n_steps, use_periods).to(torch.float32).T \
            @ g[t]
        g_w = part if g_w is None else g_w + part
    return g_w.to(w_dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    lib.snn_encode_plan.argtypes = [i] * 6 + [ip]
    lib.snn_encode_plan.restype = i
    lib.snn_encode_fwd.argtypes = [vp] * 4 + [i] * 7 + [vp]
    lib.snn_encode_fwd.restype = i
    lib.snn_encode_bwd.argtypes = [vp] * 4 + [i] * 7 + [vp]
    lib.snn_encode_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("encode_matmul")
    if not getattr(lib, "_snn_declared", False):
        _declare(lib)
    return lib


def _plan(device: torch.device, B: int, F: int, H: int, T: int,
          periodic: bool) -> Optional[Tuple[int, int, int]]:
    """(16-bit words of the forward's scratch a batch row, blocks of g_W
    slabs of the backward, 16-bit words of the backward's scratch a batch
    row) on ``device``, or None when the shape does not fit."""
    lib = _lib()
    out = (ctypes.c_int * 3)()
    rc = lib.snn_encode_plan(B, F, H, T, int(periodic), _f._index(device),
                             out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_ENC} plan")
    return out[0], out[1], out[2]


def encode_matmul_supported(n_steps: int, hidden: int, *, n_features: int,
                            device="cuda", training: bool = False,
                            use_periods: bool = True) -> bool:
    """Whether :func:`encoded_input_matmul` covers this shape on ``device``.
    On the CPU the plain versions cover every shape.  On a CUDA device the
    kernels take ``hidden <= 1024``, ``n_features <= 65535`` and
    ``n_steps <= MAX_STEPS`` where one block's shared memory holds a row's
    latencies and firing list as 16-bit words and, beside a feature chunk's
    keys, one row's ``(n_steps, 32)`` float32 table (two with
    ``use_periods``): a fixed rule (``covered`` in the source), which the
    kernels' plans fit, so the answer does not move with them."""
    del training  # the plan covers both kernels
    device = torch.device(device)
    if n_steps < 1 or hidden < 1 or n_features < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or n_steps > MAX_STEPS:
        return False
    return _plan(device, 1, n_features, hidden, n_steps,
                 use_periods) is not None


def _check(k, lat, w, n_steps, use_periods):
    dev = lat.device
    B, F = lat.shape
    H = w.shape[1]
    _f._check_weights(k, w)
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "w", w, w.dtype, (F, H), dev)
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{k}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    plan = _plan(dev, B, F, H, n_steps, use_periods)
    if plan is None:
        raise ValueError(f"{k}: shape T={n_steps} F={F} H={H} does not fit "
                         "the kernel (gate on encode_matmul_supported)")
    return B, F, H, plan


def _fwd_cuda(lat, w, n_steps, use_periods):
    """Launch ``encode_matmul_fwd``."""
    k = KERNEL_ENC
    dev = lat.device
    B, F, H, (row_len, _, _) = _check(k, lat, w, n_steps, use_periods)
    out = torch.empty((n_steps, B, H), dtype=torch.float32, device=dev)
    lists = torch.empty(B * row_len, dtype=torch.int16, device=dev)
    lib = _lib()
    rc = lib.snn_encode_fwd(
        lat.data_ptr(), w.data_ptr(), out.data_ptr(), lists.data_ptr(), B, F,
        H, n_steps, int(use_periods), int(w.dtype == torch.bfloat16),
        _f._index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return out


def _bwd_cuda(lat, g, w_dtype, n_steps, use_periods):
    """Launch ``encode_matmul_bwd`` and add the blocks' slabs in a fixed
    order."""
    k = KERNEL_ENC_BWD
    dev = lat.device
    B, F = lat.shape
    H = g.shape[2]
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "g", g, torch.float32, (n_steps, B, H), dev)
    plan = _plan(dev, B, F, H, n_steps, use_periods)
    if plan is None:
        raise ValueError(f"{k}: shape T={n_steps} F={F} H={H} does not fit "
                         "the kernel (gate on encode_matmul_supported)")
    if g.data_ptr() % 16:  # the kernel's TMA reads 16-byte aligned rows
        g = g.clone()
    _, groups, key_len = plan
    slab = torch.empty((groups, F * H), dtype=torch.float32, device=dev)
    keys = torch.empty(B * key_len, dtype=torch.int16, device=dev)
    lib = _lib()
    rc = lib.snn_encode_bwd(
        lat.data_ptr(), g.data_ptr(), keys.data_ptr(), slab.data_ptr(), B, F,
        H, n_steps, int(use_periods), groups, _f._index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return slab.sum(0).view(F, H).to(w_dtype)


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _EncodeFn(torch.autograd.Function):
    """The encoded product with its backward in W; none for the
    latencies."""

    @staticmethod
    def forward(ctx, lat, w, n_steps, use_periods, plain):
        impl = _f._impl(lat, plain)
        fwd = _fwd_cuda if impl == "cuda" else _fwd_reference
        ctx.impl, ctx.statics, ctx.w_dtype = impl, (n_steps, use_periods), \
            w.dtype
        ctx.save_for_backward(lat)
        return fwd(lat, w, n_steps, use_periods)

    @staticmethod
    def backward(ctx, g):
        (lat,) = ctx.saved_tensors
        bwd = _bwd_cuda if ctx.impl == "cuda" else _bwd_reference
        g_w = bwd(lat, g.to(torch.float32).contiguous(), ctx.w_dtype,
                  *ctx.statics)
        return None, g_w, None, None, None


def _encode(lat, w, n_steps, use_periods, plain=False):
    n_steps, use_periods = int(n_steps), bool(use_periods)
    if _f._wants_grad(w):
        return _EncodeFn.apply(lat, w, n_steps, use_periods, plain)
    fwd = _fwd_cuda if _f._impl(lat, plain) == "cuda" else _fwd_reference
    return fwd(lat, w, n_steps, use_periods)


def encoded_input_matmul(latencies: torch.Tensor, w: torch.Tensor,
                         n_steps: int, use_periods: bool = False
                         ) -> torch.Tensor:
    """(latencies (B, F) int32, W (F, H) float32 or bfloat16) -> currents
    ``(T, B, H)`` float32, differentiable in W: ``einsum('btf,fh->tbh',
    spikes, W)`` up to the order of the float32 sums."""
    return _encode(latencies, w, n_steps, use_periods)


def encoded_input_matmul_reference(latencies, w, n_steps,
                                   use_periods: bool = False
                                   ) -> torch.Tensor:
    """:func:`encoded_input_matmul` through the plain PyTorch versions,
    forward and backward, on whatever device the tensors lie."""
    return _encode(latencies, w, n_steps, use_periods, plain=True)
