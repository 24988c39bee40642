"""Recurrent LIF/ALIF scan over precomputed input currents, forward and
backward.

Port of the JAX package's ops/pallas_rec.py: ``rec_alif_scan(currents (T,
B, H) float32, masked W_rec, beta, ...)`` and ``rec_lif_scan`` -> spikes
``(T, B, H)`` in W_rec's dtype, differentiable in the currents and
``W_rec``.  A recurrent layer that no whole-layer kernel takes (too wide
for their shared memory) runs it on the currents of all steps
(models/snn.py:apply).

Dynamics (``z(-1) = 0``, ``v = a = 0`` before step 0):

    v    = (alpha v + i(t) + z(t-1) @ W_rec)(1 - z(t-1))
    ALIF: a = rho a + z(t-1), thr = threshold + beta a
    z(t) = [v - thr >= 0]

Training keeps the residuals of the JAX kernel in W_rec's dtype: ``z`` and
``delta = v - thr`` (ALIF with FastSigmoid), else ``z`` and ``v`` (and
``a`` for ALIF with Phi).  The backward (``pallas_rec.py:17-24``):

    dz   = g_z(t) + dcur(t+1) @ W_rec^T      (dcur rounded to W_rec's dtype)
    dv   = dz surr(delta(t)) + alpha dcur(t+1)
    dcur = dv (1 - z(t-1))                   -> g_i(t), float32
    g_W_rec = sum_t z(t-1)^T dcur(t)         (dcur rounded, float32 sums)

``beta`` gets a zero cotangent (quirk Q3); ``w_rec`` arrives eye-masked
(``cells.masked_recurrent``) and the mask zeroes its gradient outside.

Two hand-written CUDA kernels stand behind the wrappers
(``csrc/rec_scan.cu``): ``rec_scan_fwd`` (inference: ``z`` only) /
``rec_scan_fwd_train`` (the same arithmetic, plus the residuals), and
``rec_scan_bwd`` (the chain, then ``g_W_rec`` as a sum over spike bits).
On a CUDA tensor a wrapper launches them or raises; on the CPU it runs the
plain PyTorch versions (``_fwd_reference``, ``_bwd_reference``), which the
tests hold against the JAX kernels.  The ``*_reference`` entry points run
the plain versions on any device.

Each kernel runs one of two bodies, chosen by shape (:func:`rec_bodies`):
the tensor-core cluster body (``csrc/rec_mma.cuh``: W_rec's bf16 pieces
split across a thread-block cluster, the recurrent products on tensor
cores; the forward float32 up to H = 512 and bf16 up to 1024, the chain
bf16 up to 1024) or, elsewhere, the CUDA-core body (every float32 chain:
at H = 512 the cluster body's six piece products a slice ran slower).  ``_fwd_ordered_reference`` and ``_chain_ordered_reference`` are the
plain versions in the cluster body's summation order: the forward's bits
equal them on the card.  ``_rec_chain_ordered_reference`` is the CUDA-core
chain's, which the card tests hold it against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import fused as _f
from .fused import (
    KERNEL_REC,
    KERNEL_REC_BWD,
    KERNEL_REC_TRAIN,
    MAX_STEPS,
    Beta,
)
from .surrogate import SpikeFuncType, surrogate_grad_from_delta

__all__ = [
    "rec_alif_scan",
    "rec_lif_scan",
    "rec_alif_scan_reference",
    "rec_lif_scan_reference",
    "rec_scan_supported",
    "rec_bodies",
    "cluster_plans",
]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _fwd_loop(currents, w_rec, beta, alif, alpha, rho, threshold, train,
              store_a, res_is_v, product):
    """The forward's cell over the steps, ``product(z)`` the recurrent
    current of ``z(t-1)`` (float32 0/1): ``(z, res | None, a | None)`` in
    W_rec's dtype."""
    f32, wd = torch.float32, w_rec.dtype
    T, B, H = currents.shape
    dev = currents.device
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev) if alif else None
    v = torch.zeros((B, H), dtype=f32, device=dev)
    a = torch.zeros_like(v)
    z = torch.zeros_like(v)
    zs, res, a_tr = [], [], []
    for t in range(T):
        # The JAX kernel's order: (alpha v + i) + z @ W_rec.
        v = (alpha * v + currents[t] + product(z)) * (1.0 - z)
        thr = threshold
        if alif:
            a = rho * a + z
            thr = threshold + beta_t * a
        delta = v - thr
        z = (delta >= 0).to(f32)
        zs.append(z.to(wd))
        if train:
            res.append((v if res_is_v else delta).to(wd))
            if store_a:
                a_tr.append(a.to(wd))
    return (torch.stack(zs), torch.stack(res) if train else None,
            torch.stack(a_tr) if train and store_a else None)


def _fwd_reference(currents, w_rec, beta, alif, alpha, rho, threshold, train,
                   store_a, res_is_v):
    """Plain version of ``rec_scan_fwd[_train]``: ``(z, res | None, a |
    None)`` in W_rec's dtype; ``res`` is ``v`` or ``delta``.  bf16 weights
    are upcast (exact), so products with 0/1 spikes are exact and sums
    float32; on a card run it with ``torch.backends.cuda.matmul.allow_tf32
    = False``."""
    w32 = w_rec.to(torch.float32)
    return _fwd_loop(currents, w_rec, beta, alif, alpha, rho, threshold,
                     train, store_a, res_is_v, lambda z: z @ w32)


def _fwd_ordered_reference(currents, w_rec, beta, alif, alpha, rho,
                           threshold, train, store_a, res_is_v):
    """Plain version of the cluster body's forward (``csrc/rec_mma.cuh:
    rec_mma_fwd_kernel``) in its summation order: the cell of
    :func:`_fwd_reference`, the recurrent current ``z(t-1) @ W_rec`` taken
    per k16 slice as the tensor cores form it (``ops/fused.py:
    _slice_product``: float32 weights as three bf16 pieces, hi apart from
    lo and mid, each slice's sum added in float32 in ascending k).  The
    body's plan does not enter: every unit sums all H inputs in that order.
    Returns as :func:`_fwd_reference`; the card's bits equal it."""
    pieces = _f._weight_pieces(w_rec)
    return _fwd_loop(currents, w_rec, beta, alif, alpha, rho, threshold,
                     train, store_a, res_is_v,
                     lambda z: _f._slice_product(z, pieces))


def _bwd_loop(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha, threshold,
              gamma, spike_func, product, want_gw):
    """The backward's chain over the steps, ``product(d)`` the recurrent
    cotangent ``d @ W_rec^T`` of the rounded ``dcur(t+1)``: ``(g_i (T, B,
    H) float32, g_W_rec float32 | None)``."""
    f32, wd = torch.float32, w_rec.dtype
    T, B, H = res.shape
    dev = res.device

    def r(x):
        return x if wd == f32 else x.to(wd).to(f32)

    beta_t = (torch.as_tensor(beta, dtype=f32, device=dev)
              if a_tr is not None else None)
    dcur = torch.zeros((B, H), dtype=f32, device=dev)
    g_w = torch.zeros((H, H), dtype=f32, device=dev) if want_gw else None
    g_i = [None] * T
    for t in range(T - 1, -1, -1):
        thr = (threshold + beta_t * a_tr[t].to(f32) if a_tr is not None
               else threshold)
        d_t = res[t].to(f32) - thr if res_is_v else res[t].to(f32)
        surr = surrogate_grad_from_delta(spike_func, d_t, thr, gamma)
        dz = g_z[t].to(f32) + product(r(dcur))
        dv = dz * surr + alpha * dcur
        z_prev = (z[t - 1].to(f32) if t > 0
                  else torch.zeros((B, H), dtype=f32, device=dev))
        dcur = dv * (1.0 - z_prev)
        g_i[t] = dcur
        if want_gw:
            g_w += z_prev.T @ r(dcur)
    return torch.stack(g_i), g_w


def _bwd_reference(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha,
                   threshold, gamma, spike_func):
    """Plain version of ``rec_scan_bwd``: ``(g_i (T, B, H) float32, g_W_rec
    in W_rec's dtype)``."""
    w32 = w_rec.to(torch.float32)
    g_i, g_w = _bwd_loop(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha,
                         threshold, gamma, spike_func, lambda d: d @ w32.T,
                         True)
    return g_i, g_w.to(w_rec.dtype)


def _chain_ordered_reference(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha,
                             threshold, gamma, spike_func, card=False):
    """Plain version of the cluster body's chain (``csrc/rec_mma.cuh:
    rec_mma_chain_kernel``) in its summation order: ``g_i (T, B, H)``
    float32, with ``round(dcur(t+1)) @ W_rec^T`` per k16 slice as
    ``head_mma.cuh:mma_split_a`` forms it (``ops/fused.py:
    _split_slice_product``; ``card`` takes each tensor-core product as
    ``_mma_slice`` models the card's accumulation instead of rounding its
    exact sum to nearest)."""
    wd = w_rec.dtype
    w_t = w_rec.to(torch.float32).T.contiguous()
    return _bwd_loop(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha,
                     threshold, gamma, spike_func,
                     lambda d: _f._split_slice_product(d, w_t, wd, card=card),
                     False)[0]


def _rec_chain_ordered_reference(g_z, z, res, a_tr, res_is_v, w_rec, beta,
                                 alpha, threshold, gamma, spike_func):
    """Plain version of the CUDA-core chain (``csrc/rec_scan.cu:
    rec_chain_kernel``, every float32 chain) in its summation order: ``g_i
    (T, B, H)`` float32, with ``round(dcur(t+1)) @ W_rec^T`` as the kernel's
    j-chunk loop forms it, one fused multiply-add a term in ascending j
    into one float32 accumulator started at zero (the chunks of W_rec^T
    rows carry the accumulator on, so the chunking does not enter).  Each
    multiply-add is taken in float64 (the product exact) and rounded to
    float32: a single rounding except where the sum needs more than 53
    bits, far below the bars."""
    f64 = torch.float64
    w_t = w_rec.to(f64).T.contiguous()

    def product(d):
        d = d.to(f64)
        acc = torch.zeros(d.shape, dtype=f64, device=d.device)
        for j in range(w_t.shape[0]):
            acc = torch.addcmul(acc, d[:, j, None], w_t[j]).float().double()
        return acc.float()

    return _bwd_loop(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha,
                     threshold, gamma, spike_func, product, False)[0]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.snn_rec_scan_plan.argtypes = [i] * 5 + [ip]
    lib.snn_rec_scan_plan.restype = i
    lib.snn_rec_scan_fwd.argtypes = [vp] * 6 + [i] * 6 + [f] * 3 + [i, vp]
    lib.snn_rec_scan_fwd.restype = i
    lib.snn_rec_scan_bwd.argtypes = [vp] * 9 + [i] * 7 + [f] * 3 + [i, vp]
    lib.snn_rec_scan_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("rec_scan")
    if not getattr(lib, "_snn_declared", False):
        _declare(lib)
    return lib


PLAN_KEYS = ("body", "cluster", "units", "rows", "buffers", "active")


def _plan_all(device: torch.device, B: int, H: int, T: int,
              bf16: bool) -> Optional[dict]:
    """The kernels' plan at batch ``B``: ``groups`` (blocks of ``g_W_rec``
    slabs of the backward) and, for ``fwd`` and ``chain``, a dict of
    ``PLAN_KEYS``: the body ("mma", the tensor-core cluster body, or
    "cuda-core") and, on the cluster body, blocks a cluster, units a block,
    rows a cluster, exchange buffers and the clusters the card keeps active
    at once (zeros on the CUDA-core body).  None when the shape does not
    fit the kernels."""
    lib = _lib()
    out = (ctypes.c_int * 13)()
    rc = lib.snn_rec_scan_plan(B, H, T, int(bf16), _f._index(device), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_REC} plan")
    plan = {"groups": out[0]}
    for i, kind in enumerate(("fwd", "chain")):
        vals = list(out[1 + 6 * i:7 + 6 * i])
        vals[0] = "mma" if vals[0] else "cuda-core"
        plan[kind] = dict(zip(PLAN_KEYS, vals))
    return plan


def _plan(device: torch.device, B: int, H: int, T: int,
          bf16: bool) -> Optional[int]:
    """Blocks of ``g_W_rec`` slabs of the backward at batch ``B``, or None
    when the shape does not fit the kernels."""
    plan = _plan_all(device, B, H, T, bf16)
    return None if plan is None else plan["groups"]


def cluster_plans(n_steps: int, hidden: int, batch: int, *,
                  itemsize: int = 4, device="cuda") -> Optional[dict]:
    """The forward's and the chain's plans at ``batch`` rows on the card
    (``_plan_all``'s ``fwd`` and ``chain``), or None where the kernels do
    not take the shape."""
    plan = _plan_all(torch.device(device), batch, hidden, n_steps,
                     itemsize == 2)
    return None if plan is None else {k: plan[k] for k in ("fwd", "chain")}


def rec_bodies(n_steps: int, hidden: int, *, itemsize: int = 4,
               device="cuda") -> tuple:
    """The bodies the forward and the backward's chain run a shape on:
    ("mma" | "cuda-core", "mma" | "cuda-core").  By shape only: the cluster
    body where W_rec's pieces and the exchange buffers fit a block when
    split across at most 16 blocks (the forward float32 up to H = 512, bf16
    up to 1024; the chain bf16 up to 1024), the CUDA-core body elsewhere
    (every float32 chain).  On the CPU the plain versions
    ("plain", "plain"); raises where the kernels do not take the shape."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("plain", "plain")
    plans = cluster_plans(n_steps, hidden, 1, itemsize=itemsize,
                          device=device)
    if plans is None:
        raise ValueError(f"{KERNEL_REC}: T={n_steps} H={hidden} does not fit "
                         "the kernels (gate on rec_scan_supported)")
    return plans["fwd"]["body"], plans["chain"]["body"]


def rec_scan_supported(n_steps: int, hidden: int, *, itemsize: int = 4,
                       device="cuda", training: bool = False) -> bool:
    """Whether the recurrent scan covers this shape on ``device``.  On the
    CPU the plain versions cover every shape.  On a CUDA device the kernels
    need ``W_rec`` in float32 or bfloat16, ``hidden <= 1024`` and
    ``n_steps <= MAX_STEPS``: the cluster body splits W_rec across blocks,
    and past it the CUDA-core body streams W_rec through shared memory in
    chunks, so its size sets no limit (:func:`rec_bodies` names the body);
    the backward's ``g_W_rec`` (``gbits_mma``) streams ``g_i`` through a
    ring of 64-row stages."""
    del training  # one plan covers both kernels
    device = torch.device(device)
    if n_steps < 1 or hidden < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    return _plan(device, 1, hidden, n_steps, itemsize == 2) is not None


def _check_w(k, w_rec, H, dev):
    _f._check_weights(k, w_rec)
    _f._check(k, "w_rec", w_rec, w_rec.dtype, (H, H), dev)


def _fwd_cuda(currents, w_rec, beta, alif, alpha, rho, threshold, train,
              store_a, res_is_v):
    """Launch ``rec_scan_fwd`` (``rec_scan_fwd_train`` with ``train``);
    returns as :func:`_fwd_reference`."""
    k = KERNEL_REC_TRAIN if train else KERNEL_REC
    dev = currents.device
    T, B, H = currents.shape
    _f._check(k, "currents", currents, torch.float32, (T, B, H), dev)
    _check_w(k, w_rec, H, dev)
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"{k}: n_steps must be in [1, {MAX_STEPS}], got {T}")
    bf16 = w_rec.dtype == torch.bfloat16
    if _plan(dev, B, H, T, bf16) is None:
        raise ValueError(f"{k}: shape T={T} H={H} does not fit the kernel "
                         "(gate on rec_scan_supported)")
    trace = dict(dtype=w_rec.dtype, device=dev)
    z = torch.empty((T, B, H), **trace)
    res = torch.empty((T, B, H), **trace) if train else None
    a_tr = torch.empty((T, B, H), **trace) if train and store_a else None
    beta_t = _f._beta_tensor(beta, dev)  # held until the launch
    lib = _lib()
    rc = lib.snn_rec_scan_fwd(
        currents.data_ptr(), w_rec.data_ptr(), beta_t.data_ptr(),
        z.data_ptr(), _f._ptr(res), _f._ptr(a_tr), B, H, T, int(alif),
        int(bf16), int(res_is_v), alpha, rho, threshold, _f._index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return z, res, a_tr


def _bwd_cuda(g_z, z, res, a_tr, res_is_v, w_rec, beta, alpha, threshold,
              gamma, spike_func, keep=None):
    """Launch ``rec_scan_bwd`` (the chain, then ``g_W_rec`` as
    ``gbits_mma``'s tensor-core product over the spike bits) and add the
    blocks' slabs in a fixed order.  A dict ``keep`` receives the z bits
    (``zmask``, ``(T, B, HW)``: row ``(t, b)`` holds ``z(t - 1)``) and the
    float32 sum of ``g_W_rec`` before its cast (for tests)."""
    k = KERNEL_REC_BWD
    dev = res.device
    T, B, H = res.shape
    wdt = w_rec.dtype
    _check_w(k, w_rec, H, dev)
    for name, t in (("g_z", g_z), ("z", z), ("res", res), ("a", a_tr)):
        if t is not None:
            _f._check(k, name, t, wdt, (T, B, H), dev)
    bf16 = wdt == torch.bfloat16
    groups = _plan(dev, B, H, T, bf16)
    if groups is None:
        raise ValueError(f"{k}: shape T={T} H={H} does not fit the kernel "
                         "(gate on rec_scan_supported)")
    w_t = w_rec.t().contiguous()  # the chain streams rows of W_rec^T
    g_i = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    zmask = torch.empty((T, B, (H + 31) // 32), dtype=torch.int32,
                        device=dev)
    slab = torch.empty((groups, H * H), dtype=torch.float32, device=dev)
    beta_t = _f._beta_tensor(beta, dev)
    lib = _lib()
    rc = lib.snn_rec_scan_bwd(
        g_z.data_ptr(), z.data_ptr(), res.data_ptr(), _f._ptr(a_tr),
        w_t.data_ptr(), beta_t.data_ptr(), g_i.data_ptr(), zmask.data_ptr(),
        slab.data_ptr(), B, H, T, int(spike_func == SpikeFuncType.Phi),
        int(bf16), int(res_is_v), groups, alpha, threshold, gamma,
        _f._index(dev), torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    _f._launched_function(_f.KERNEL_GBITS)
    rec_sum = _f.gbits_sums(slab, None).view(H, H)
    if keep is not None:
        keep.update(zmask=zmask, g_w_rec=rec_sum)
    return g_i, rec_sum.to(wdt)


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _RecFn(torch.autograd.Function):
    """The scan with its backward: the training forward keeps ``z`` and
    the residuals."""

    @staticmethod
    def forward(ctx, currents, w_rec, beta, statics, plain):
        alif, alpha, rho, threshold, gamma, spike_func = statics
        impl = _f._impl(currents, plain)
        fwd = _fwd_cuda if impl == "cuda" else _fwd_reference
        res_is_v = _f._residual_is_v(alif, spike_func)
        z, res, a_tr = fwd(currents, w_rec, beta, alif, alpha, rho,
                           threshold, True, _f._stores_a(alif, spike_func),
                           res_is_v)
        ctx.impl, ctx.statics, ctx.beta, ctx.res_is_v = (impl, statics, beta,
                                                         res_is_v)
        ctx.save_for_backward(w_rec, z, res, a_tr)
        return z

    @staticmethod
    def backward(ctx, g_z):
        w_rec, z, res, a_tr = ctx.saved_tensors
        _, alpha, _, threshold, gamma, spike_func = ctx.statics
        bwd = _bwd_cuda if ctx.impl == "cuda" else _bwd_reference
        g_i, g_w = bwd(g_z.to(z.dtype).contiguous(), z, res, a_tr,
                       ctx.res_is_v, w_rec, ctx.beta, alpha, threshold, gamma,
                       spike_func)
        return g_i, g_w, _f._zero_beta_grad(ctx.beta), None, None


def _scan(currents, w_rec, beta, alif, alpha, rho, threshold, gamma,
          spike_func, plain=False):
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    currents = currents.to(torch.float32).contiguous()
    statics = (bool(alif), float(alpha), float(rho), float(threshold),
               float(gamma), spike_func)
    if _f._wants_grad(currents, w_rec, beta):
        return _RecFn.apply(currents, w_rec, beta, statics, plain)
    fwd = (_fwd_cuda if _f._impl(currents, plain) == "cuda"
           else _fwd_reference)
    # Inference: only the spike trace leaves.
    return fwd(currents, w_rec, beta, *statics[:4], False, False, False)[0]


def rec_alif_scan(currents: torch.Tensor, w_rec: torch.Tensor, beta: Beta,
                  alpha: float, rho: float, threshold: float, gamma: float,
                  spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
                  ) -> torch.Tensor:
    """Recurrent ALIF: currents ``(T, B, H)`` float32, masked ``W_rec (H,
    H)`` float32 or bfloat16 -> spikes ``(T, B, H)`` in W_rec's dtype,
    differentiable in the currents and ``W_rec``.  ``beta`` may be a tensor
    (``learn_beta``); its gradient is zero."""
    return _scan(currents, w_rec, beta, True, alpha, rho, threshold, gamma,
                 spike_func)


def rec_lif_scan(currents: torch.Tensor, w_rec: torch.Tensor, alpha: float,
                 threshold: float, gamma: float,
                 spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
                 ) -> torch.Tensor:
    """Recurrent LIF: as :func:`rec_alif_scan` without adaptation."""
    return _scan(currents, w_rec, 0.0, False, alpha, 0.0, threshold, gamma,
                 spike_func)


def rec_alif_scan_reference(currents, w_rec, beta, alpha, rho, threshold,
                            gamma,
                            spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
                            ) -> torch.Tensor:
    """:func:`rec_alif_scan` through the plain PyTorch versions, forward and
    backward, on whatever device the tensors lie."""
    return _scan(currents, w_rec, beta, True, alpha, rho, threshold, gamma,
                 spike_func, plain=True)


def rec_lif_scan_reference(currents, w_rec, alpha, threshold, gamma,
                           spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`rec_lif_scan`."""
    return _scan(currents, w_rec, 0.0, False, alpha, 0.0, threshold, gamma,
                 spike_func, plain=True)
