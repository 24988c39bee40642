"""Izhikevich first layer and whole-network head: encode + input product +
Izhikevich scan [+ readout + max over time] in one call, forward and
backward.

Port of the JAX package's ops/pallas_fused_izh.py, the Izhikevich
counterparts of ops/fused.py's LIF/ALIF calls:

* ``fused_encode_izh_scan``: latencies ``(B, F)`` int32, ``W_in``, masked
  ``W_rec`` (or None) -> spikes ``z (T, B, H)`` float32 (whatever the
  weights' dtype, as the JAX kernel), the first layer of a deeper network;
* ``fused_encode_izh_scan_head``: the whole single-hidden-layer network,
  spike rows -> ``W_in`` -> Izhikevich scan -> readout ``v = kappa v + z @
  W_out + b`` -> running max with strict ``>`` -> logits ``(B, O)``;
* ``fused_encode_izh_scan_head_counts``: the same plus the spike counts
  ``(B, H)``, differentiable in both (the counts' cotangent joins ``dz`` at
  every step).

Residuals follow the JAX kernel: the head keeps only the float32 membrane
trace ``v (T, B, H)`` and its backward recomputes ``z = v >= v_peak`` (the
forward took z from exactly that float); the first layer keeps ``z`` and
``v``, both float32.  The dynamics and the two-carry backward are those of
ops/izh.py, whose plain loops these wrappers share.

Three hand-written CUDA kernels stand behind the wrappers:

* ``fused_izh_fwd`` (``csrc/fused_izh.cu``): the head, inference (logits
  only); ``fused_izh_fwd_train``, the same template with ``v``, ``tstar``
  and counts (bitwise-equal logits); ``fused_izh_layer0_fwd``, the template
  without the readout, writing ``z`` (and ``v`` for training);
* ``fused_izh_bwd`` and ``fused_izh_layer0_bwd`` (``csrc/fused_izh_bwd.cu``,
  one source, head and first-layer mode): the two-carry chain, then the
  LIF/ALIF weight-gradient functions of ``csrc/bwd_common.cuh``.

The forwards and the backwards' chains (head and first layer) run the
LIF/ALIF head's tensor-core body (``csrc/head_mma_fwd.cuh``,
``csrc/chain_mma.cuh``) with the Izhikevich cell and chain as its policies
wherever it fits (O <= 16, H <= 256, the weights' bf16 pieces within a
block's shared memory; a first layer's chain is the body's z-layer mode);
other shapes run the per-unit body (one thread a (row, unit)).
:func:`head_bodies` and
:func:`layer0_bodies` name the body of a shape;
:func:`_izh_head_train_ordered_reference`,
:func:`_izh_layer0_ordered_reference` and
:func:`_izh_bwd_ordered_reference` are the plain versions in the
tensor-core body's summation order, the forwards' bit for bit on the card.

The head also runs stacked replicas (an ensemble of S seeds on one batch,
the JAX package's stacked-replica mode): ``W_in (S, F, H)`` and a leading S
on every weight and on ``b_out`` give logits ``(S, B, O)`` from one launch
of ``fused_izh_fwd_stacked`` (inference) or ``fused_izh_fwd_train_stacked``
and ``fused_izh_bwd_stacked`` (training), each replica bitwise a single
launch.  Stacked is the head only, as in the JAX package (a stacked first
layer raises), and takes no spike counts.

On a CUDA tensor a wrapper launches the kernels or raises; on the CPU it
runs the plain PyTorch versions, which the tests hold against the JAX
kernels.  The ``*_reference`` entry points run the plain versions on any
device.  Products take the weights' dtype (float32 or bfloat16) with
float32 sums; in the backward ``s`` and ``gi`` are rounded to it before each
product; ``b_out`` is float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused as _f
from . import izh as _izh
from .encoding import spike_row
from .head_mma import list_row_words
from .fused import (
    KERNEL_IZH,
    KERNEL_IZH_BWD,
    KERNEL_IZH_BWD_STACKED,
    KERNEL_IZH_L0,
    KERNEL_IZH_L0_BWD,
    KERNEL_IZH_STACKED,
    KERNEL_IZH_TRAIN,
    KERNEL_IZH_TRAIN_STACKED,
    MAX_STEPS,
)
from .surrogate import SpikeFuncType

__all__ = [
    "fused_encode_izh_scan",
    "fused_encode_izh_scan_head",
    "fused_encode_izh_scan_head_counts",
    "fused_encode_izh_scan_reference",
    "fused_encode_izh_scan_head_reference",
    "fused_encode_izh_scan_head_counts_reference",
    "fused_izh_supported",
    "fused_izh_head_supported",
    "layer0_bodies",
]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _head_reference(lat, w_in, w_rec, w_out, b_out, n_steps, use_periods,
                    kernel_params, kappa, train, want_counts):
    """Plain version of ``fused_izh_fwd[_train]``: ``(logits, v | None,
    tstar | None, counts | None)``; ``train`` keeps ``v`` and ``tstar``."""
    logits, _, v, tstar, counts = _izh._izh_loop(
        _f._latency_currents(lat, w_in, n_steps, use_periods), lat.shape[0],
        w_in.shape[1], lat.device, w_rec, n_steps, kernel_params, w_out,
        b_out, kappa, keep_v=train, train=train, want_counts=want_counts)
    return logits, v, tstar, counts


def _head_stacked_reference(lat, w_in, w_rec, w_out, b_out, *rest):
    """Plain version of ``fused_izh_fwd[_train]_stacked``: the single plain
    version once per replica, stacked (a leading S on every output)."""
    return _f._stack_outs([
        _head_reference(lat, w_in[s], _f._rec_at(w_rec, s), w_out[s],
                        b_out[s], *rest)
        for s in range(w_in.shape[0])])


def _bwd_stacked_reference(g_logits, g_counts, tstar, g_z, z, v, lat, w_in,
                           w_rec, w_out, *rest):
    """Plain version of ``fused_izh_bwd_stacked`` (the head): ``(g_w_in,
    g_w_rec | None, g_w_out, g_b)`` with a leading S."""
    if g_counts is not None or w_out is None:
        raise ValueError(f"{KERNEL_IZH_BWD_STACKED}: the stacked mode is the "
                         "head without spike counts")
    return _f._stack_outs([
        _bwd_reference(g_logits[s], None, tstar[s], None, None, v[s], lat,
                       w_in[s], _f._rec_at(w_rec, s), w_out[s], *rest)
        for s in range(w_in.shape[0])])


def _layer0_reference(lat, w_in, w_rec, n_steps, use_periods, kernel_params,
                      train):
    """Plain version of ``fused_izh_layer0_fwd``: ``(z, v | None)``
    float32."""
    _, z, v, _, _ = _izh._izh_loop(
        _f._latency_currents(lat, w_in, n_steps, use_periods), lat.shape[0],
        w_in.shape[1], lat.device, w_rec, n_steps, kernel_params,
        keep_z=True, keep_v=train)
    return z, v


def _bwd_reference(g_logits, g_counts, tstar, g_z, z, v, lat, w_in, w_rec,
                   w_out, n_steps, use_periods, kernel_params, gamma, kappa,
                   spike_func):
    """Plain version of ``fused_izh_bwd`` (``w_out`` given) and
    ``fused_izh_layer0_bwd``: ``(g_w_in, g_w_rec | None, g_w_out | None,
    g_b | None)``, the weights' gradients in the weights' dtype."""
    f32 = torch.float32
    _, g_w_in, g_w_rec, g_w_out, g_b = _izh._izh_bwd_loop(
        lambda t: spike_row(lat, t, n_steps, use_periods).to(f32), g_logits,
        g_counts, tstar, g_z, v, z, w_rec, w_out, kernel_params, gamma,
        kappa, spike_func, w_in.dtype)
    return (g_w_in.to(w_in.dtype),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype),
            None if g_w_out is None else g_w_out.to(w_out.dtype), g_b)


def _izh_head_train_ordered_reference(lat, w_in, w_rec, w_out, b_out,
                                      n_steps, use_periods, kernel_params,
                                      kappa, train, want_counts):
    """Plain version of the tensor-core body of ``fused_izh_fwd[_train]``
    (``csrc/head_mma_fwd.cuh:head_mma_kernel`` with the Izhikevich cell) in
    its summation order (``ops/fused.py:_ordered_head``: the input current
    from each row's features in key order, TTFS rows at >= F / 16 spikes
    as a k16-sliced product, the recurrent and readout products per k16
    slice); the cell step is the plain loop's (``ops/izh.py:_cell_step``).
    Returns as :func:`_head_reference` (without ``w_out``: a first layer,
    ``(None, v | None, None, counts | None)``)."""
    f32 = torch.float32
    v_rest = dict(kernel_params)["v_rest"]
    shape = (lat.shape[0], w_in.shape[1])
    step = _izh._cell_step(kernel_params, lat.device)
    zeros = torch.zeros(shape, dtype=f32, device=lat.device)
    st = dict(v=torch.full(shape, v_rest, dtype=f32, device=lat.device),
              u=zeros, z=zeros, counts=zeros)
    vs = []

    def cell(cur):
        st["v"], st["u"], st["z"] = step(st["v"], st["u"], st["z"], cur)
        st["counts"] = st["counts"] + st["z"]
        if train:
            vs.append(st["v"])
        return st["z"]

    logits, tstar = _f._ordered_head(lat, w_in, w_rec, w_out, b_out, n_steps,
                                     use_periods, kappa, cell)
    return (logits, torch.stack(vs) if train else None,
            tstar if train else None, st["counts"] if want_counts else None)


def _izh_layer0_ordered_reference(lat, w_in, w_rec, n_steps, use_periods,
                                  kernel_params, train):
    """Plain version of ``fused_izh_layer0_fwd``'s tensor-core body
    (``csrc/head_mma_fwd.cuh:mma_layer`` with the Izhikevich cell, no
    readout) in its summation order: :func:`_izh_head_train_ordered_reference`
    without the readout (``ops/fused.py:_ordered_head``).  Returns as
    :func:`_layer0_reference`: ``(z, v | None)`` float32."""
    _, v, _, _ = _izh_head_train_ordered_reference(
        lat, w_in, w_rec, None, None, n_steps, use_periods, kernel_params,
        0.0, True, False)
    z = (v >= dict(kernel_params)["v_peak"]).to(torch.float32)
    return z, v if train else None


def _izh_bwd_ordered_reference(g_logits, g_counts, tstar, g_z, z, v, lat,
                               w_in, w_rec, w_out, n_steps, use_periods,
                               kernel_params, gamma, kappa, spike_func,
                               order, keep=None):
    """Plain version of ``fused_izh_bwd`` (the head, ``w_out`` given) and
    ``fused_izh_layer0_bwd`` (a first layer: ``g_z`` and the stored ``z``,
    no readout) in their order: the two-carry chain with the tensor-core
    body's products (``ops/fused.py:_split_slice_product``), and from the
    chain's rounded ``gi`` ``g_W_in`` through ``_gwin_ordered_reference``,
    ``g_W_rec`` through ``gbits._gbits_ordered_reference``, the head's
    ``g_W_out`` and ``g_b`` through ``_gout_ordered_reference``.  ``order``
    is the kernel's plan (:func:`gradient_plan`, ``O == 0`` for a first
    layer).  Returns as :func:`_bwd_reference`.  A dict ``keep`` receives
    the chain's rounded ``gi (B, T, H)`` float32 as ``dcur``."""
    from .gbits import _gbits_ordered_reference

    f32 = torch.float32
    wd = w_in.dtype
    T, B, H = v.shape
    head = w_out is not None
    gi = torch.zeros((B, T, H), dtype=f32, device=v.device)
    _izh._izh_bwd_loop(
        None, g_logits, g_counts, tstar, None if head else g_z, v,
        None if head else z, w_rec, w_out, kernel_params, gamma, kappa,
        spike_func, wd, gi_out=gi,
        matmul=lambda a, w: _f._split_slice_product(a, w.contiguous(), wd))
    if keep is not None:
        keep["dcur"] = gi
    zv = ((v >= dict(kernel_params)["v_peak"]).to(f32) if head
          else z.to(f32))
    g_w_rec = None
    if w_rec is not None:
        z_prev = torch.cat([torch.zeros_like(zv[:1]), zv[:-1]])
        g_w_rec = _gbits_ordered_reference(
            gi.view(B * T, H), z_prev.transpose(0, 1).reshape(B * T, H), B,
            T, order["groups_rec"], wd).to(w_rec.dtype)
    g_w_in = _f._gwin_ordered_reference(gi, lat, n_steps, use_periods,
                                        order["groups_in"], order["rows_in"])
    if not head:
        return g_w_in.to(wd), g_w_rec, None, None
    g_w_out, g_b = _f._gout_ordered_reference(
        zv, g_logits, tstar, kappa, wd, order["groups_out"],
        order["rows_out"])
    return g_w_in.to(wd), g_w_rec, g_w_out.to(w_out.dtype), g_b


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL, name: str) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    if name == "fused_izh":
        lib.snn_fused_izh_plan.argtypes = [i] * 6 + [ip]
        lib.snn_fused_izh_plan.restype = i
        lib.snn_fused_izh_fwd.argtypes = (
            [vp] * 10 + [i] * 7 + [f] * 11 + [i, i, vp])
        lib.snn_fused_izh_fwd.restype = i
        lib.snn_fused_izh_layer0_fwd.argtypes = (
            [vp] * 6 + [i] * 6 + [f] * 10 + [i, vp])
        lib.snn_fused_izh_layer0_fwd.restype = i
    else:
        lib.snn_fused_izh_bwd_plan.argtypes = [i] * 9 + [ip]
        lib.snn_fused_izh_bwd_plan.restype = i
        lib.snn_fused_izh_bwd.argtypes = (
            [vp] * 14 + [i] * 8 + [f] * 9 + [i, i, vp])
        lib.snn_fused_izh_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib(name: str = "fused_izh") -> ctypes.CDLL:
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_snn_declared", False):
        _declare(lib, name)
    return lib


def _plan(device: torch.device, F: int, H: int, O: int, recurrent: bool,
          bf16: bool) -> Optional[bool]:
    """Whether the forward kernels run the shape on their tensor-core body
    (True) or their per-unit body (False; ``O == 0``: the first-layer
    mode), or None when the shape does not fit."""
    lib = _lib()
    mma = ctypes.c_int(0)
    rc = lib.snn_fused_izh_plan(F, H, O, int(recurrent), int(bf16),
                                _f._index(device), ctypes.byref(mma))
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_IZH} plan")
    return bool(mma.value)


def _plan_bwd_words(device, B, F, H, O, T, recurrent, bf16, use_periods):
    """``snn_fused_izh_bwd_plan``'s eight words, or None when the shape
    does not fit the backward (``O == 0``: the first-layer mode)."""
    lib = _lib("fused_izh_bwd")
    out = (ctypes.c_int * 8)()
    rc = lib.snn_fused_izh_bwd_plan(B, F, H, O, T, int(recurrent), int(bf16),
                                    int(use_periods), _f._index(device), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_IZH_BWD} plan")
    return list(out)


def _plan_bwd(device: torch.device, B: int, F: int, H: int, O: int, T: int,
              recurrent: bool, bf16: bool,
              use_periods: bool) -> Optional[Tuple[int, int, int, bool]]:
    """Blocks of (g_W_in, g_W_rec, g_W_out/g_b) slabs of the backward
    kernel and whether its chain takes the tensor-core body (``O == 0``:
    the first-layer mode, the body's z-layer mode), or None when the shape
    does not fit."""
    out = _plan_bwd_words(device, B, F, H, O, T, recurrent, bf16,
                          use_periods)
    return None if out is None else (out[0], out[1], out[2], bool(out[3]))


def gradient_plan(device, B: int, F: int, H: int, O: int, T: int,
                  recurrent: bool, bf16: bool, use_periods: bool) -> dict:
    """The order of ``fused_izh_bwd``'s gradient functions on ``device``
    for a head's shape (``O == 0``: ``fused_izh_layer0_bwd``'s), as
    ``ops.fused.gradient_plan`` gives the LIF/ALIF head's (the same
    functions): ``groups_in`` / ``groups_rec`` / ``groups_out`` blocks of
    ``bwd_gwin`` / ``gbits_mma`` / ``bwd_gout``, ``rows_in`` / ``rows_out``
    rows a batch, ``gwin_ring`` / ``gbits_ring``, and ``mma``, whether the
    chain takes the tensor-core body.  :func:`_izh_bwd_ordered_reference`
    takes it."""
    out = _plan_bwd_words(torch.device(device), B, F, H, O, T, recurrent,
                          bf16, use_periods)
    if out is None:
        raise ValueError(f"{KERNEL_IZH_BWD}: shape T={T} F={F} H={H} O={O} "
                         "does not fit the kernel")
    return dict(_f.plan_order(out), mma=bool(out[3]))


def _supported(n_steps, n_features, hidden, n_out, recurrent, itemsize,
               device, training, use_periods) -> bool:
    device = torch.device(device)
    if n_steps < 1 or hidden < 1 or n_features < 1 or n_out < 0:
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


def fused_izh_supported(n_steps: int, n_features: int, hidden: int,
                        recurrent: bool = True, itemsize: int = 4,
                        device="cuda", training: bool = False,
                        use_periods: bool = True) -> bool:
    """Whether the z-emitting Izhikevich first layer covers this shape on
    ``device``: the gates of ``ops.fused.fused_supported`` (float32 or
    bfloat16 weights, ``hidden <= 1024``, ``n_features <= 65535``, ``W_rec``
    and the rows' latencies in shared memory, with ``training`` the
    backward's per-row tables too).  The plain versions cover every shape
    on the CPU."""
    return _supported(n_steps, n_features, hidden, 0, recurrent, itemsize,
                      device, training, use_periods)


def head_bodies(n_steps: int, n_features: int, hidden: int, n_out: int,
                recurrent: bool = True, itemsize: int = 4, device="cuda",
                training: bool = False,
                use_periods: bool = True) -> Tuple[str, ...]:
    """The body each Izhikevich head kernel runs a shape on, for a shape
    :func:`fused_izh_head_supported` takes on a CUDA device, as
    ``ops.fused.head_bodies`` names the LIF/ALIF head's: ``"mma"`` (the
    tensor-core body, ``csrc/head_mma_fwd.cuh`` and ``chain_mma.cuh``) or
    ``"per-unit"`` (O > 16, H > 256, or the weights' bf16 pieces past a
    block's shared memory).  One entry for the forward, a second for the
    backward's chain with ``training``."""
    device = torch.device(device)
    bf16 = itemsize == 2
    fwd = _plan(device, n_features, hidden, n_out, recurrent, bf16)
    bodies = ["mma" if fwd else "per-unit"]
    if training:
        bwd = _plan_bwd(device, 1, n_features, hidden, n_out, n_steps,
                        recurrent, bf16, use_periods)
        bodies.append("mma" if bwd and bwd[3] else "per-unit")
    return tuple(bodies)


def layer0_bodies(n_steps: int, n_features: int, hidden: int,
                  recurrent: bool = True, itemsize: int = 4, device="cuda",
                  training: bool = False,
                  use_periods: bool = True) -> Tuple[str, ...]:
    """The body each Izhikevich first-layer kernel runs a shape on, for a
    shape :func:`fused_izh_supported` takes on a CUDA device:
    ``"mma"`` (``fused_izh_layer0_fwd`` on the tensor-core body without the
    readout) or ``"per-unit"`` (H > 256, or W_rec's bf16 pieces past a
    block's shared memory); a second entry with ``training``:
    ``fused_izh_layer0_bwd``'s chain, ``"mma"`` on the tensor-core chain
    body (its z-layer mode) or ``"per-unit"`` past the same limits, from the
    kernel's plan.  On the CPU the plain versions: ``"plain"`` entries."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("plain",) * (1 + int(training))
    bf16 = itemsize == 2
    fwd = _plan(device, n_features, hidden, 0, recurrent, bf16)
    out = ("mma" if fwd else "per-unit",)
    if training:
        bwd = _plan_bwd(device, 1, n_features, hidden, 0, n_steps, recurrent,
                        bf16, use_periods)
        out += ("mma" if bwd and bwd[3] else "per-unit",)
    return out


def fused_izh_head_supported(n_steps: int, n_features: int, hidden: int,
                             n_out: int, recurrent: bool = True,
                             itemsize: int = 4, device="cuda",
                             training: bool = False,
                             use_periods: bool = True) -> bool:
    """:func:`fused_izh_supported` for the head, which also keeps ``W_out``
    and the readout state in shared memory."""
    if n_out < 1:
        return False
    return _supported(n_steps, n_features, hidden, n_out, recurrent,
                      itemsize, device, training, use_periods)


def _check_forward(k, lat, w_in, w_rec, w_out, b_out, n_steps, S=None):
    """Validate the forward kernels' inputs (a leading S on the weights of
    ``S`` stacked replicas); returns (B, F, H, O, the list scratch of the
    tensor-core body or None)."""
    dev = lat.device
    _f._check_weights(k, w_in)
    wdt = w_in.dtype
    B, F = lat.shape
    H = w_in.shape[-1]
    O = 0 if w_out is None else w_out.shape[-1]
    lead = _f._lead(S)
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "w_in", w_in, wdt, (*lead, F, H), dev)
    if w_rec is not None:
        _f._check(k, "w_rec", w_rec, wdt, (*lead, H, H), dev)
    if w_out is not None:
        _f._check(k, "w_out", w_out, wdt, (*lead, H, O), dev)
        _f._check(k, "b_out", b_out, torch.float32, (*lead, O), dev)
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{k}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    mma = _plan(dev, F, H, O, w_rec is not None, wdt == torch.bfloat16)
    if mma is None:
        raise ValueError(f"{k}: shape F={F} H={H} O={O} does not fit the "
                         "kernel (gate on fused_izh[_head]_supported)")
    # Each row's features ordered by spike key (head_mma.head_lists).
    lists = (torch.empty((B, list_row_words(F)), dtype=torch.int16,
                         device=dev) if mma else None)
    return B, F, H, O, lists


def _head_cuda(lat, w_in, w_rec, w_out, b_out, n_steps, use_periods,
               kernel_params, kappa, train, want_counts):
    """Launch ``fused_izh_fwd`` or, for ``train`` or ``want_counts``,
    ``fused_izh_fwd_train`` (their ``_stacked`` launches for stacked
    weights); returns as :func:`_head_reference`, with a leading S when
    stacked."""
    S = _f._replicas(w_in, KERNEL_IZH)
    k = KERNEL_IZH_TRAIN if train or want_counts else KERNEL_IZH
    if S is not None:
        if want_counts:
            raise ValueError(f"{k}: the stacked head has no spike counts")
        k = KERNEL_IZH_TRAIN_STACKED if train else KERNEL_IZH_STACKED
    dev = lat.device
    B, F, H, O, lists = _check_forward(k, lat, w_in, w_rec, w_out, b_out,
                                       n_steps, S)
    lead = _f._lead(S)
    f32 = dict(dtype=torch.float32, device=dev)
    logits = torch.empty((*lead, B, O), **f32)
    v = torch.empty((*lead, n_steps, B, H), **f32) if train else None
    tstar = (torch.empty((*lead, B, O), dtype=torch.int32, device=dev)
             if train else None)
    counts = torch.empty((B, H), **f32) if want_counts else None
    lib = _lib()
    p = _f._ptr
    rc = lib.snn_fused_izh_fwd(
        lat.data_ptr(), w_in.data_ptr(), p(w_rec), w_out.data_ptr(),
        b_out.data_ptr(), logits.data_ptr(), p(v), p(tstar), p(counts),
        p(lists), B, F, H, O, n_steps, int(use_periods),
        int(w_in.dtype == torch.bfloat16), *_izh._consts(kernel_params),
        float(kappa), S or 1, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return logits, v, tstar, counts


def _layer0_cuda(lat, w_in, w_rec, n_steps, use_periods, kernel_params,
                 train):
    """Launch ``fused_izh_layer0_fwd``; returns as
    :func:`_layer0_reference`."""
    k = KERNEL_IZH_L0
    dev = lat.device
    B, F, H, _, lists = _check_forward(k, lat, w_in, w_rec, None, None,
                                       n_steps)
    z = torch.empty((n_steps, B, H), dtype=torch.float32, device=dev)
    v = torch.empty_like(z) if train else None
    lib = _lib()
    rc = lib.snn_fused_izh_layer0_fwd(
        lat.data_ptr(), w_in.data_ptr(), _f._ptr(w_rec), z.data_ptr(),
        _f._ptr(v), _f._ptr(lists), B, F, H, n_steps, int(use_periods),
        int(w_in.dtype == torch.bfloat16), *_izh._consts(kernel_params),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return z, v


def _bwd_cuda(g_logits, g_counts, tstar, g_z, z, v, lat, w_in, w_rec, w_out,
              n_steps, use_periods, kernel_params, gamma, kappa, spike_func,
              keep=None):
    """Launch ``fused_izh_bwd`` (``w_out`` given; ``fused_izh_bwd_stacked``
    for stacked weights) or ``fused_izh_layer0_bwd`` (the chain and the
    weight-gradient functions in one call) and add the blocks' slabs in a
    fixed order; returns as :func:`_bwd_reference`.  A dict ``keep``
    receives the chain's rounded ``gi`` (``dcur``), the z bits (``zmask``)
    and the float32 sum of ``g_W_rec`` before its cast (for tests)."""
    head = w_out is not None
    S = _f._replicas(w_in, KERNEL_IZH_BWD)
    k = KERNEL_IZH_BWD if head else KERNEL_IZH_L0_BWD
    if S is not None:
        if not head or g_counts is not None:
            raise ValueError(f"{k}: the stacked mode is the head without "
                             "spike counts")
        k = KERNEL_IZH_BWD_STACKED
    lead = _f._lead(S)
    dev = lat.device
    B, F = lat.shape
    H = w_in.shape[-1]
    O = w_out.shape[-1] if head else 0
    T = n_steps
    wdt = w_in.dtype
    _f._check_weights(k, w_in)
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "v", v, torch.float32, (*lead, T, B, H), dev)
    if w_rec is not None:
        _f._check(k, "w_rec", w_rec, wdt, (*lead, H, H), dev)
    if head:
        _f._check(k, "w_out", w_out, wdt, (*lead, H, O), dev)
        _f._check(k, "g_logits", g_logits, torch.float32, (*lead, B, O), dev)
        _f._check(k, "tstar", tstar, torch.int32, (*lead, B, O), dev)
        if g_counts is not None:
            _f._check(k, "g_counts", g_counts, torch.float32, (B, H), dev)
    else:
        _f._check(k, "g_z", g_z, torch.float32, (T, B, H), dev)
        _f._check(k, "z", z, torch.float32, (T, B, H), dev)
    bf16 = wdt == torch.bfloat16
    plan = _plan_bwd(dev, B, F, H, O, T, w_rec is not None, bf16,
                     use_periods)
    if plan is None:
        raise ValueError(
            f"{k}: shape T={T} F={F} H={H} O={O} does not fit the kernel "
            "(gate on fused_izh[_head]_supported(training=True))")
    n_in, n_rec, n_out, _ = plan
    f32 = dict(dtype=torch.float32, device=dev)
    # Scratch of the call: gi(t) per row, rounded, and the bits of z.
    dcur = torch.empty((*lead, B, T, H), dtype=wdt, device=dev)
    zmask = torch.empty((*lead, B, T + 1, (H + 31) // 32), dtype=torch.int32,
                        device=dev)
    slab_in = torch.empty((*lead, n_in, F * H), **f32)
    slab_rec = torch.empty((*lead, n_rec, H * H), **f32)
    slab_out = torch.empty((*lead, n_out, H * O + O), **f32)
    lib = _lib("fused_izh_bwd")
    p = _f._ptr
    rc = lib.snn_fused_izh_bwd(
        p(g_logits), p(tstar), p(g_counts), p(g_z), p(z), v.data_ptr(),
        lat.data_ptr(), p(w_rec), p(w_out), dcur.data_ptr(),
        zmask.data_ptr(), slab_in.data_ptr(), slab_rec.data_ptr(),
        slab_out.data_ptr(), B, F, H, O, T, int(use_periods),
        int(spike_func == SpikeFuncType.Phi), int(bf16),
        *_izh._bwd_consts(kernel_params), float(gamma), float(kappa),
        S or 1, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    _f._launched_function(_f.KERNEL_GBITS, int(w_rec is not None))
    g_w_in = _f.slab_sums(slab_in, S).view(*lead, F, H).to(wdt)
    rec_sum = (None if w_rec is None
               else _f.gbits_sums(slab_rec, S).view(*lead, H, H))
    if keep is not None:
        keep.update(dcur=dcur, zmask=zmask, g_w_rec=rec_sum)
    g_w_rec = None if rec_sum is None else rec_sum.to(wdt)
    if not head:
        return g_w_in, g_w_rec, None, None
    out_sum = _f.slab_sums(slab_out, S)
    return (g_w_in, g_w_rec,
            out_sum[..., :H * O].reshape(*lead, H, O).to(wdt),
            out_sum[..., H * O:].clone())


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _HeadFn(torch.autograd.Function):
    """The head with its backward: the training forward keeps ``v`` and
    ``tstar``.  Outputs: ``logits``, or ``(logits, counts)``."""

    @staticmethod
    def forward(ctx, lat, w_in, w_rec, w_out, b_out, statics, want_counts,
                plain):
        n_steps, use_periods, kp, gamma, kappa, spike_func = statics
        impl = _f._impl(lat, plain)
        fwd = (_head_cuda if impl == "cuda"
               else _head_stacked_reference if w_in.dim() == 3
               else _head_reference)
        logits, v, tstar, counts = fwd(lat, w_in, w_rec, w_out, b_out,
                                       n_steps, use_periods, kp, kappa, True,
                                       want_counts)
        ctx.impl, ctx.statics = impl, statics
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(lat, w_in, w_rec, w_out, v, tstar)
        return (logits, counts) if want_counts else logits

    @staticmethod
    def backward(ctx, g_logits, g_counts=None):
        lat, w_in, w_rec, w_out, v, tstar = ctx.saved_tensors
        n_steps, use_periods, kp, gamma, kappa, spike_func = ctx.statics
        g_logits = (torch.zeros(tstar.shape, dtype=torch.float32,
                                device=lat.device) if g_logits is None
                    else g_logits.to(torch.float32).contiguous())
        if g_counts is not None:
            g_counts = g_counts.to(torch.float32).contiguous()
        bwd = (_bwd_cuda if ctx.impl == "cuda"
               else _bwd_stacked_reference if w_in.dim() == 3
               else _bwd_reference)
        g_w_in, g_w_rec, g_w_out, g_b = bwd(
            g_logits, g_counts, tstar, None, None, v, lat, w_in, w_rec, w_out,
            n_steps, use_periods, kp, gamma, kappa, spike_func)
        return None, g_w_in, g_w_rec, g_w_out, g_b, None, None, None


class _Layer0Fn(torch.autograd.Function):
    """The z-emitting first layer with its backward (keeps ``z`` and
    ``v``)."""

    @staticmethod
    def forward(ctx, lat, w_in, w_rec, statics, plain):
        n_steps, use_periods, kp, gamma, spike_func = statics
        impl = _f._impl(lat, plain)
        fwd = _layer0_cuda if impl == "cuda" else _layer0_reference
        z, v = fwd(lat, w_in, w_rec, n_steps, use_periods, kp, True)
        ctx.impl, ctx.statics = impl, statics
        ctx.save_for_backward(lat, w_in, w_rec, z, v)
        return z

    @staticmethod
    def backward(ctx, g_z):
        lat, w_in, w_rec, z, v = ctx.saved_tensors
        n_steps, use_periods, kp, gamma, spike_func = ctx.statics
        bwd = _bwd_cuda if ctx.impl == "cuda" else _bwd_reference
        g_w_in, g_w_rec, _, _ = bwd(
            None, None, None, g_z.to(torch.float32).contiguous(), z, v, lat,
            w_in, w_rec, None, n_steps, use_periods, kp, gamma, 0.0,
            spike_func)
        return None, g_w_in, g_w_rec, None, None


def _statics(n_steps, use_periods, kernel_params, gamma, spike_func):
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    return (int(n_steps), bool(use_periods), tuple(kernel_params),
            float(gamma), spike_func)


def _head(lat, w_in, w_rec, w_out, b_out, kernel_params, n_steps,
          use_periods, gamma, kappa, spike_func, want_counts, plain=False):
    n_steps, use_periods, kp, gamma, spike_func = _statics(
        n_steps, use_periods, kernel_params, gamma, spike_func)
    kappa = float(kappa)
    stacked = _f._replicas(w_in, KERNEL_IZH) is not None
    if stacked and want_counts:
        raise ValueError("the stacked Izhikevich head has no _counts "
                         "variant (no ensemble trains with a spike "
                         "regularizer)")
    if _f._wants_grad(w_in, w_rec, w_out, b_out):
        statics = (n_steps, use_periods, kp, gamma, kappa, spike_func)
        return _HeadFn.apply(lat, w_in, w_rec, w_out, b_out, statics,
                             want_counts, plain)
    fwd = (_head_cuda if _f._impl(lat, plain) == "cuda"
           else _head_stacked_reference if stacked else _head_reference)
    # Inference: no residual leaves the kernel.
    logits, _, _, counts = fwd(lat, w_in, w_rec, w_out, b_out, n_steps,
                               use_periods, kp, kappa, False, want_counts)
    return (logits, counts) if want_counts else logits


def _layer0(lat, w_in, w_rec, kernel_params, n_steps, use_periods, gamma,
            spike_func, plain=False):
    if w_in.dim() != 2:  # as the JAX kernel: stacked is the head only
        raise ValueError("fused_encode_izh_scan: the stacked-replica mode "
                         "is the head only; w_in must be (F, H), got "
                         f"{tuple(w_in.shape)}")
    statics = _statics(n_steps, use_periods, kernel_params, gamma,
                       spike_func)
    if _f._wants_grad(w_in, w_rec):
        return _Layer0Fn.apply(lat, w_in, w_rec, statics, plain)
    fwd = (_layer0_cuda if _f._impl(lat, plain) == "cuda"
           else _layer0_reference)
    return fwd(lat, w_in, w_rec, *statics[:3], False)[0]


def fused_encode_izh_scan(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: Optional[torch.Tensor],
    kernel_params: tuple,
    n_steps: int,
    use_periods: bool,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """(latencies (B, F) int32, W_in [, masked W_rec or None]) -> spikes
    ``(T, B, H)`` float32, differentiable in the weights: encoding, input
    product and the Izhikevich scan of a deeper network's first layer in
    one call.  ``kernel_params`` is ``ops.izh.izh_kernel_params`` of the
    layer's config."""
    return _layer0(latencies, w_in, w_rec, kernel_params, n_steps,
                   use_periods, gamma, spike_func)


def fused_encode_izh_scan_reference(
    latencies, w_in, w_rec, kernel_params, n_steps, use_periods, gamma,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """:func:`fused_encode_izh_scan` through the plain PyTorch versions,
    forward and backward, on whatever device the tensors lie."""
    return _layer0(latencies, w_in, w_rec, kernel_params, n_steps,
                   use_periods, gamma, spike_func, plain=True)


def fused_encode_izh_scan_head(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: Optional[torch.Tensor],
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    kernel_params: tuple,
    n_steps: int,
    use_periods: bool,
    gamma: float,
    kappa: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """The whole single-hidden-layer Izhikevich network: (latencies (B, F)
    int32, weights) -> logits ``(B, O)``, differentiable in the weights and
    the bias.  Stacked weights (a leading S on each weight and on
    ``b_out``) run S replicas in one launch and return ``(S, B, O)``."""
    return _head(latencies, w_in, w_rec, w_out, b_out, kernel_params,
                 n_steps, use_periods, gamma, kappa, spike_func, False)


def fused_encode_izh_scan_head_counts(
    latencies, w_in, w_rec, w_out, b_out, kernel_params, n_steps,
    use_periods, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`fused_encode_izh_scan_head` but returns ``(logits (B,
    O), spike_counts (B, H))`` float32, differentiable in both."""
    return _head(latencies, w_in, w_rec, w_out, b_out, kernel_params,
                 n_steps, use_periods, gamma, kappa, spike_func, True)


def fused_encode_izh_scan_head_reference(
    latencies, w_in, w_rec, w_out, b_out, kernel_params, n_steps,
    use_periods, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encode_izh_scan_head`."""
    return _head(latencies, w_in, w_rec, w_out, b_out, kernel_params,
                 n_steps, use_periods, gamma, kappa, spike_func, False,
                 plain=True)


def fused_encode_izh_scan_head_counts_reference(
    latencies, w_in, w_rec, w_out, b_out, kernel_params, n_steps,
    use_periods, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_encode_izh_scan_head_counts`."""
    return _head(latencies, w_in, w_rec, w_out, b_out, kernel_params,
                 n_steps, use_periods, gamma, kappa, spike_func, True,
                 plain=True)
