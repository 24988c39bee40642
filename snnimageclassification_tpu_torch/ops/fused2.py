"""Two hidden LIF/ALIF layers, the readout and the max over time as one
kernel pair.

Port of the JAX package's ops/pallas_fused2.py.  For a classifier with
exactly two hidden layers one call computes the whole network from integer
latencies: spike rows -> ``W0`` -> (recurrent) layer 0 -> ``W1`` ->
(recurrent) layer 1 -> readout ``v = kappa v + z1 @ W_out + b`` -> running
max with strict ``>`` (the first maximal step wins).  Both layers share the
cell class and the scalars (``alpha``, ``rho``, ``threshold``, ``gamma``,
the surrogate); each has its own ``beta``.  The ``_counts`` variants also
return both layers' spike counts ``(cnt0 (B, H1), cnt1 (B, H2))``.

It computes what ``fused_encode_*_scan`` + ``fused_mid_*_scan_head`` compute
(the composed pair), without layer 0's ``(T, B, H1)`` spike trace in device
memory.  Two hand-written CUDA kernels stand behind the wrappers:

* ``fused2_fwd`` / ``fused2_fwd_train`` (``csrc/fused2.cu``): inference
  writes the logits only, training the same logits bitwise plus each
  layer's residual ``delta`` (and ``a`` for ALIF with Phi) as ``(T, B,
  H)`` in the weights' dtype, ``tstar`` and on request both counts.  Two
  bodies, chosen by shape (:func:`fused2_bodies`): the tensor-core body
  (layer 0 the head's tensor-core layer, layer 1 one step behind on its own
  warps with ``z0 @ W1`` on tensor cores; its bits are those of
  ``_fused2_fwd_ordered_reference``) and, past its limits, the per-unit
  body, whose sums are the composed per-unit kernels' in the same order.
* ``fused2_bwd`` (``csrc/fused2_bwd.cu``): layer 1's reverse chain,
  ``dcur1 @ W1^T`` as a tensor-core product (``csrc/gzin_mma.cuh``),
  layer 0's chain, and the six weight gradients as slabs summed in a fixed
  order.  Both chains run the tensor-core chain body
  (``csrc/chain_mma.cuh``) where :func:`fused2_bodies` says ``"mma"``, else
  the per-unit chain; ``_fused2_bwd_ordered_reference`` is its plain
  version in its summation order.

On a CUDA tensor a wrapper launches the kernels or raises; on the CPU it
runs the plain PyTorch versions (``_fused2_reference``,
``_fused2_bwd_reference``), which the tests hold against the JAX kernels.
The ``*_reference`` entry points run the plain versions on any device.
Operand and rounding rules are those of ``ops/fused.py``; both betas get a
zero cotangent.  The recurrent weights must already be eye-masked.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused as _f
from .encoding import spike_row
from .fused import KERNEL_2, KERNEL_2_BWD, KERNEL_2_TRAIN, MAX_STEPS, Beta
from .surrogate import SpikeFuncType

__all__ = [
    "fused2_rec_head",
    "fused2_ff_head",
    "fused2_rec_head_counts",
    "fused2_ff_head_counts",
    "fused2_rec_head_reference",
    "fused2_ff_head_reference",
    "fused2_rec_head_counts_reference",
    "fused2_ff_head_counts_reference",
    "fused2_head_supported",
    "fused2_bodies",
]

Counts = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _fused2_reference(lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out,
                      n_steps, use_periods, alif, alpha, rho, threshold,
                      kappa, train, store_a, want_counts):
    """Plain version of ``fused2_fwd[_train]``: a time loop of layer 0, then
    layer 1 on z0(t), then the readout, each step in the kernel's order
    (``fused._Cell``, ``fused._Readout``).  Returns ``(logits, d0, a0, d1,
    a1, tstar, cnt0, cnt1)`` with None for what the mode does not produce;
    ``train`` keeps the residuals (``a`` with ``store_a``), rounded once to
    the weights' dtype, and ``tstar``, ``want_counts`` both counts.  bf16
    weights are upcast (exact), so every product with a 0/1 spike is exact
    and every sum float32."""
    f32 = torch.float32
    dev, wd = lat.device, w0.dtype
    B = lat.shape[0]
    w0_32, w1_32 = w0.to(f32), w1.to(f32)
    l0 = _f._Cell(B, w0.shape[1], dev, w0r, beta0, alif, want_counts)
    l1 = _f._Cell(B, w1.shape[1], dev, w1r, beta1, alif, want_counts)
    readout = _f._Readout(B, w_out, b_out, kappa, dev)
    traces = ([], [], [], [])  # d0, d1, a0, a1
    for t in range(n_steps):
        d0 = l0.step(spike_row(lat, t, n_steps, use_periods).to(f32) @ w0_32,
                     alpha, rho, threshold)
        d1 = l1.step(l0.z @ w1_32, alpha, rho, threshold)
        readout.step(l1.z, t, train)
        if train:  # rounded once, here
            keep = (d0, d1, l0.a, l1.a) if store_a else (d0, d1)
            for trace, x in zip(traces, keep):
                trace.append(x.to(wd))
    d0s, d1s, a0s, a1s = map(_f._stack, traces)
    return (readout.m, d0s, a0s, d1s, a1s, readout.tstar if train else None,
            l0.counts, l1.counts)


def _fused2_fwd_ordered_reference(lat, w0, w0r, beta0, w1, w1r, beta1,
                                  w_out, b_out, n_steps, use_periods, alif,
                                  alpha, rho, threshold, kappa, train,
                                  store_a, want_counts):
    """Plain version of ``fused2_fwd[_train]``'s tensor-core body
    (``csrc/fused2.cu:fused2_mma_kernel``) in its summation order; returns
    as :func:`_fused2_reference`.  Layer 0 is the head body's first layer
    (``ops/fused.py:_ordered_input``, the code of
    ``fused._layer0_ordered_reference``), every product k16-sliced as the
    tensor cores form it (``_slice_product``): layer 0's recurrent current
    added to its input current past step 0; layer 1's input current ``z0(t)
    @ W1``, its recurrent current added past step 0; the readout ``v_r =
    kappa v_r + (z1(t) @ W_out + b)``.  The cell steps are the plain loop's
    (``fused._Cell``)."""
    dev, wd = lat.device, w0.dtype
    B = lat.shape[0]
    pieces = _f._weight_pieces
    cur0 = _f._ordered_input(lat, w0, w0r, n_steps, use_periods)
    w1_p = pieces(w1)
    rec1_p = None if w1r is None else pieces(w1r)
    l0 = _f._Cell(B, w0.shape[1], dev, None, beta0, alif, want_counts)
    l1 = _f._Cell(B, w1.shape[1], dev, None, beta1, alif, want_counts)
    readout = _f._Readout(B, w_out, b_out, kappa, dev, sliced=True)
    traces = ([], [], [], [])  # d0, d1, a0, a1
    for t in range(n_steps):
        c1_rec = None
        if rec1_p is not None and t > 0:
            c1_rec = _f._slice_product(l1.z, rec1_p)
        d0 = l0.step(cur0(t, l0.z), alpha, rho, threshold)
        c1 = _f._slice_product(l0.z, w1_p)
        if c1_rec is not None:
            c1 = c1 + c1_rec
        d1 = l1.step(c1, alpha, rho, threshold)
        readout.step(l1.z, t, train)
        if train:  # rounded once, here
            keep = (d0, d1, l0.a, l1.a) if store_a else (d0, d1)
            for trace, x in zip(traces, keep):
                trace.append(x.to(wd))
    d0s, d1s, a0s, a1s = map(_f._stack, traces)
    return (readout.m, d0s, a0s, d1s, a1s, readout.tstar if train else None,
            l0.counts, l1.counts)


def _fused2_bwd_reference(g_logits, g_cnt0, g_cnt1, tstar, d0, a0, d1, a1,
                          lat, w0, w0r, beta0, w1, w1r, beta1, w_out, n_steps,
                          use_periods, alpha, threshold, gamma, kappa,
                          spike_func):
    """Plain version of ``fused2_bwd``: layer 1 as a head whose input spikes
    are ``z0 = d0 >= 0`` (its backward also gives ``dz0_in = dcur1 @
    W1^T``, float32, as the kernel's scratch), then layer 0 as a z-layer
    from ``dz0_in + g_cnt0``.  Returns ``(g_w0, g_w0r | None, g_w1, g_w1r |
    None, g_w_out, g_b)``, the weights' gradients in the weights' dtype."""
    f32 = torch.float32
    z0 = (d0.to(f32) >= 0).to(f32)
    dz0, g_w1, g_w1r, g_w_out, g_b = _f._bwd_loop(
        lambda t: z0[t], w1.to(f32).T, g_logits, g_cnt1, tstar, None, d1, a1,
        None, False, w1r, beta1, w_out, n_steps, alpha, threshold, gamma,
        kappa, spike_func, w1.dtype)
    if g_cnt0 is not None:
        dz0 = dz0 + g_cnt0
    _, g_w0, g_w0r, _, _ = _f._bwd_loop(
        lambda t: spike_row(lat, t, n_steps, use_periods).to(f32), None,
        None, None, None, dz0, d0, a0, z0, False, w0r, beta0, None, n_steps,
        alpha, threshold, gamma, 0.0, spike_func, w0.dtype)

    def cast(g, w):
        return None if g is None else g.to(w.dtype)

    return (cast(g_w0, w0), cast(g_w0r, w0r), cast(g_w1, w1),
            cast(g_w1r, w1r), cast(g_w_out, w_out), g_b)


def _fused2_bwd_ordered_reference(g_logits, g_cnt0, g_cnt1, tstar, d0, a0,
                                  d1, a1, lat, w0, w0r, beta0, w1, w1r, beta1,
                                  w_out, n_steps, use_periods, alpha,
                                  threshold, gamma, kappa, spike_func, order,
                                  card=False, keep=None):
    """Plain version of ``fused2_bwd`` in its summation order; returns as
    :func:`_fused2_bwd_reference`.  Layer 1's chain (a head) and layer 0's
    (from ``dz0_in + g_cnt0``) with the tensor-core chain body's products
    (``fused._split_slice_product``); ``dz0_in = dcur1 @ W1^T`` through
    ``fused._gzin_ordered_reference`` (float32, as the kernel's scratch;
    ``card``: the card's accumulation model); ``g_W0`` through
    ``fused._gwin_ordered_reference``, ``g_W0r``, ``g_W1`` (left operand
    ``z0(t)``) and ``g_W1r`` through ``gbits._gbits_ordered_reference``,
    ``g_W_out`` and ``g_b`` through ``fused._gout_ordered_reference``.
    ``order`` is the kernel's plan (:func:`gradient_plan`).  A dict
    ``keep`` receives both chains' rounded ``dcur0``, ``dcur1`` and
    ``dz0`` (float32)."""
    from .fused_mid import _step_rows
    from .gbits import _gbits_ordered_reference

    f32 = torch.float32
    wd = w0.dtype
    B = lat.shape[0]
    T = n_steps
    H1, H2 = w0.shape[1], w1.shape[1]
    dev = lat.device

    def mm(a, w):
        return _f._split_slice_product(a, w.contiguous(), wd)

    z0 = (d0.to(f32) >= 0).to(f32)
    dcur1 = torch.zeros((B, T, H2), dtype=f32, device=dev)
    _f._bwd_loop(lambda t: z0[t], None, g_logits, g_cnt1, tstar, None, d1,
                 a1, None, False, w1r, beta1, w_out, n_steps, alpha,
                 threshold, gamma, kappa, spike_func, wd, dcur_out=dcur1,
                 matmul=mm)
    dz0 = _f._gzin_ordered_reference(dcur1, w1, wd, card)
    if g_cnt0 is not None:
        dz0 = dz0 + g_cnt0
    dcur0 = torch.zeros((B, T, H1), dtype=f32, device=dev)
    _f._bwd_loop(lambda t: spike_row(lat, t, n_steps, use_periods).to(f32),
                 None, None, None, None, dz0, d0, a0, z0, False, w0r, beta0,
                 None, n_steps, alpha, threshold, gamma, 0.0, spike_func, wd,
                 dcur_out=dcur0, matmul=mm)
    if keep is not None:
        keep.update(dcur0=dcur0, dcur1=dcur1, dz0=dz0)
    d0r, d1r = dcur0.view(B * T, H1), dcur1.view(B * T, H2)
    g_w0 = _f._gwin_ordered_reference(dcur0, lat, n_steps, use_periods,
                                      order["groups_in"], order["rows_in"])
    g_w1 = _gbits_ordered_reference(d1r, _step_rows(z0), B, T,
                                    order["groups_w1"], wd)
    g_w0r = g_w1r = None
    if w0r is not None:
        g_w0r = _gbits_ordered_reference(d0r, _f.z_prev_rows(d0), B, T,
                                         order["groups_rec0"], wd)
        g_w1r = _gbits_ordered_reference(d1r, _f.z_prev_rows(d1), B, T,
                                         order["groups_rec1"], wd)
    g_w_out, g_b = _f._gout_ordered_reference(
        (d1 >= 0).to(f32), g_logits, tstar, kappa, wd, order["groups_out"],
        order["rows_out"])

    def cast(g, w):
        return None if g is None else g.to(w.dtype)

    return (cast(g_w0, w0), cast(g_w0r, w0r), cast(g_w1, w1),
            cast(g_w1r, w1r), cast(g_w_out, w_out), g_b)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL, name: str) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    if name == "fused2":
        lib.snn_fused2_plan.argtypes = [i] * 7 + [ip, ip]
        lib.snn_fused2_plan.restype = i
        lib.snn_fused2_fwd.argtypes = (
            [vp] * 17 + [i] * 9 + [f] * 4 + [i, vp, i, vp])
        lib.snn_fused2_fwd.restype = i
        lib.snn_fused2_body.argtypes = [i] * 8 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.snn_fused2_body.restype = i
    else:
        lib.snn_fused2_bwd_plan.argtypes = [i] * 10 + [ip]
        lib.snn_fused2_bwd_plan.restype = i
        lib.snn_fused2_bwd.argtypes = (
            [vp] * 25 + [i] * 9 + [f] * 4 + [i, vp])
        lib.snn_fused2_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib(name: str = "fused2") -> ctypes.CDLL:
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_snn_declared", False):
        _declare(lib, name)
    return lib


def _plan(device: torch.device, F: int, H1: int, H2: int, O: int,
          recurrent: bool, bf16: bool) -> Optional[Tuple[int, int]]:
    """(rows per block, shared-memory bytes) of ``fused2_fwd`` on
    ``device``, or None when the shape does not fit."""
    lib = _lib()
    rows, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_fused2_plan(F, H1, H2, O, int(recurrent), int(bf16),
                             _f._index(device), ctypes.byref(rows),
                             ctypes.byref(smem))
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_2} plan")
    return rows.value, smem.value


def _body(device: torch.device, F: int, H1: int, H2: int, O: int,
          recurrent: bool, bf16: bool, B: int = 0) -> Tuple[bool, int]:
    """``fused2_fwd``'s body for a shape it takes: (the tensor-core body,
    bytes of scratch a launch of ``B`` rows needs: the rows' feature lists
    and W1's fragments where its bf16 pieces do not fit shared memory and
    come from L2)."""
    lib = _lib()
    out = (ctypes.c_longlong * 3)()
    rc = lib.snn_fused2_body(F, H1, H2, O, int(recurrent), int(bf16), B,
                             _f._index(device), out)
    _f._raise_on(rc, lib, f"{KERNEL_2} body")
    return bool(out[0]), int(out[2])


def fused2_bodies(n_steps: int, n_features: int, h1: int, h2: int,
                  n_out: int, recurrent: bool = True, itemsize: int = 4, *,
                  device="cuda", training: bool = False,
                  use_periods: bool = True) -> Tuple[str, ...]:
    """The body each two-layer kernel runs a shape on, for a shape
    :func:`fused2_head_supported` takes on a CUDA device: ``"mma"`` (the
    tensor-core body: layer 0 the head body's layer, layer 1 the mid
    body's, on their own warps of a tile, one step apart) or
    ``"per-unit"`` (one thread a (row, unit) of both layers; O > 16, the
    two layers' units past 256 (each rounded up to 32), or the weights'
    bf16 pieces past a block's shared memory).  One entry for the forward,
    a second for the backward's chains (``fused2_bwd``: the tensor-core
    chain body, ``"mma"``, where both layers' units are at most 256, O <=
    16 and the weights' bf16 pieces fit a block's shared memory, else the
    per-unit chains) with ``training``.  On the CPU the plain versions:
    ``"plain"`` entries."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("plain",) * (1 + int(training))
    bf16 = itemsize == 2
    mma = _body(device, n_features, h1, h2, n_out, recurrent, bf16)[0]
    out = ("mma" if mma else "per-unit",)
    if training:
        words = _plan_bwd_words(device, 1, n_features, h1, h2, n_out,
                                n_steps, recurrent, bf16, use_periods)
        out += ("mma" if words is not None and words[5] else "per-unit",)
    return out


def _plan_bwd_words(device: torch.device, B: int, F: int, H1: int, H2: int,
                    O: int, T: int, recurrent: bool, bf16: bool,
                    use_periods: bool) -> Optional[Tuple[int, ...]]:
    """``snn_fused2_bwd_plan``'s eight words on ``device``, or None when
    the shape does not fit."""
    lib = _lib("fused2_bwd")
    out = (ctypes.c_int * 8)()
    rc = lib.snn_fused2_bwd_plan(B, F, H1, H2, O, T, int(recurrent),
                                 int(bf16), int(use_periods),
                                 _f._index(device), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_2_BWD} plan")
    return tuple(out)


def _plan_bwd(device: torch.device, B: int, F: int, H1: int, H2: int, O: int,
              T: int, recurrent: bool, bf16: bool,
              use_periods: bool) -> Optional[Tuple[int, ...]]:
    """Blocks of (g_W0, g_W0r, g_W1, g_W1r, g_W_out/g_b) partial slabs of
    ``fused2_bwd`` on ``device``, or None when the shape does not fit."""
    out = _plan_bwd_words(device, B, F, H1, H2, O, T, recurrent, bf16,
                          use_periods)
    return None if out is None else out[:5]


def gradient_plan(device, B: int, F: int, H1: int, H2: int, O: int, T: int,
                  recurrent: bool, bf16: bool, use_periods: bool) -> dict:
    """The order of ``fused2_bwd`` on ``device`` for a shape: the blocks
    (slabs) of ``bwd_gwin`` (``groups_in``, ``rows_in`` rows a batch),
    ``gbits_mma`` (``groups_rec0``, ``groups_w1``, ``groups_rec1``) and
    ``bwd_gout`` (``groups_out``, ``rows_out``), and ``mma``, whether both
    chains take the tensor-core body.  :func:`_fused2_bwd_ordered_reference`
    takes it."""
    out = _plan_bwd_words(torch.device(device), B, F, H1, H2, O, T,
                          recurrent, bf16, use_periods)
    if out is None:
        raise ValueError(f"{KERNEL_2_BWD}: shape T={T} F={F} H1={H1} "
                         f"H2={H2} O={O} does not fit the kernel")
    return {"groups_in": out[0], "groups_rec0": out[1], "groups_w1": out[2],
            "groups_rec1": out[3], "groups_out": out[4], "mma": bool(out[5]),
            "rows_in": out[6], "rows_out": out[7]}


def fused2_head_supported(n_steps: int, n_features: int, h1: int, h2: int,
                          n_out: int, recurrent: bool = True,
                          itemsize: int = 4, *, device="cuda",
                          training: bool = False,
                          use_periods: bool = True) -> bool:
    """Whether the two-layer pair covers this shape on ``device``.

    On the CPU the plain versions cover every shape.  On a CUDA device the
    forward kernel needs float32 or bfloat16 weights, ``max(h1, h2) <=
    1024`` (one thread per unit of both layers), ``n_features <= 65535``,
    ``n_steps <= MAX_STEPS`` and ``W0r``, ``W1``, ``W1r`` and ``W_out`` with
    one row's state within the block's shared memory (197 KB of weights in
    float32 at 128-128-10, against 227 KB); with ``training`` the backward
    kernel must fit too (one row's ``(n_steps, h)`` float32 tables in shared
    memory, two with ``use_periods``).  A shape that does not fit is refused
    here, never at launch."""
    device = torch.device(device)
    if min(n_steps, n_features, h1, h2, n_out) < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    bf16 = itemsize == 2
    if _plan(device, n_features, h1, h2, n_out, recurrent, bf16) is None:
        return False
    return not training or _plan_bwd(
        device, 1, n_features, h1, h2, n_out, n_steps, recurrent, bf16,
        use_periods) is not None


def _check_fwd(k, lat, w0, w0r, w1, w1r, w_out, b_out, n_steps):
    """Validate the forward's inputs; returns (B, F, H1, H2, O, rows)."""
    dev = lat.device
    _f._check_weights(k, w0)
    wdt = w0.dtype
    B, F = lat.shape
    H1, H2, O = w0.shape[1], w1.shape[1], w_out.shape[1]
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{k}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    if (w0r is None) != (w1r is None):
        raise ValueError(f"{k}: both layers are recurrent or neither is")
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "w0", w0, wdt, (F, H1), dev)
    _f._check(k, "w1", w1, wdt, (H1, H2), dev)
    if w0r is not None:
        _f._check(k, "w0_rec", w0r, wdt, (H1, H1), dev)
        _f._check(k, "w1_rec", w1r, wdt, (H2, H2), dev)
    _f._check(k, "w_out", w_out, wdt, (H2, O), dev)
    _f._check(k, "b_out", b_out, torch.float32, (O,), dev)
    plan = _plan(dev, F, H1, H2, O, w0r is not None, wdt == torch.bfloat16)
    if plan is None:
        raise ValueError(
            f"{k}: shape F={F} H1={H1} H2={H2} O={O} does not fit the kernel "
            "(gate on fused2_head_supported)")
    return B, F, H1, H2, O, plan[0]


def _fused2_cuda(lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out, n_steps,
                 use_periods, alif, alpha, rho, threshold, kappa, train,
                 store_a, want_counts):
    """Launch ``fused2_fwd`` (logits only) or, with ``train`` or
    ``want_counts``, ``fused2_fwd_train``; returns as
    :func:`_fused2_reference`."""
    k = KERNEL_2_TRAIN if train or want_counts else KERNEL_2
    dev = lat.device
    B, F, H1, H2, O, rows = _check_fwd(k, lat, w0, w0r, w1, w1r, w_out,
                                       b_out, n_steps)
    f32 = dict(dtype=torch.float32, device=dev)
    trace = dict(dtype=w0.dtype, device=dev)
    logits = torch.empty((B, O), **f32)
    d0 = torch.empty((n_steps, B, H1), **trace) if train else None
    d1 = torch.empty((n_steps, B, H2), **trace) if train else None
    a0 = torch.empty((n_steps, B, H1), **trace) if train and store_a else None
    a1 = torch.empty((n_steps, B, H2), **trace) if train and store_a else None
    tstar = (torch.empty((B, O), dtype=torch.int32, device=dev) if train
             else None)
    cnt0 = torch.empty((B, H1), **f32) if want_counts else None
    cnt1 = torch.empty((B, H2), **f32) if want_counts else None
    # Both betas held until the launch: a temporary's block would go back
    # to the caching allocator and be handed to the other.
    beta0_t, beta1_t = _f._beta_tensor(beta0, dev), _f._beta_tensor(beta1,
                                                                  dev)
    lib = _lib()
    p = _f._ptr
    bf16 = w0.dtype == torch.bfloat16
    _, nbytes = _body(dev, F, H1, H2, O, w0r is not None, bf16, B)
    # The rows' feature lists and W1's fragments, on the tensor-core body.
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    rc = lib.snn_fused2_fwd(
        lat.data_ptr(), w0.data_ptr(), p(w0r), beta0_t.data_ptr(),
        w1.data_ptr(), p(w1r), beta1_t.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), logits.data_ptr(), p(d0), p(a0), p(d1), p(a1),
        p(tstar), p(cnt0), p(cnt1), B, F, H1, H2, O, n_steps,
        int(use_periods), int(alif), int(bf16), alpha, rho, threshold,
        kappa, rows, p(scratch), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return logits, d0, a0, d1, a1, tstar, cnt0, cnt1


def _fused2_bwd_cuda(g_logits, g_cnt0, g_cnt1, tstar, d0, a0, d1, a1, lat,
                     w0, w0r, beta0, w1, w1r, beta1, w_out, n_steps,
                     use_periods, alpha, threshold, gamma, kappa, spike_func,
                     keep=None):
    """Launch ``fused2_bwd`` (its ``__global__`` functions in one call) and
    add the blocks' partial slabs in a fixed order; returns as
    :func:`_fused2_bwd_reference`.  A dict ``keep`` receives both chains'
    rounded ``dcur0``, ``dcur1``, their z bits (``zmask0`` with its padding
    row, ``zmask1``), ``dz0 = dcur1 @ W1^T`` and the float32 sums of
    ``gbits_mma``'s ``g_W0r``, ``g_W1``, ``g_W1r`` before their cast (for
    tests)."""
    k = KERNEL_2_BWD
    dev = lat.device
    _f._check_weights(k, w0)
    wdt = w0.dtype
    B, F = lat.shape
    H1, H2, O = w0.shape[1], w1.shape[1], w_out.shape[1]
    T = n_steps
    rec = w0r is not None
    if rec != (w1r is not None) or (a0 is None) != (a1 is None):
        raise ValueError(f"{k}: both layers' recurrent weights and "
                         "adaptation traces, or neither")
    _f._check(k, "g_logits", g_logits, torch.float32, (B, O), dev)
    _f._check(k, "tstar", tstar, torch.int32, (B, O), dev)
    for name, t, h in (("g_cnt0", g_cnt0, H1), ("g_cnt1", g_cnt1, H2)):
        if t is not None:
            _f._check(k, name, t, torch.float32, (B, h), dev)
    for name, t, h in (("d0", d0, H1), ("a0", a0, H1), ("d1", d1, H2),
                       ("a1", a1, H2)):
        if t is not None:
            _f._check(k, name, t, wdt, (T, B, h), dev)
    _f._check(k, "latencies", lat, torch.int32, (B, F), dev)
    _f._check(k, "w1", w1, wdt, (H1, H2), dev)
    if rec:
        _f._check(k, "w0_rec", w0r, wdt, (H1, H1), dev)
        _f._check(k, "w1_rec", w1r, wdt, (H2, H2), dev)
    _f._check(k, "w_out", w_out, wdt, (H2, O), dev)
    bf16 = wdt == torch.bfloat16
    plan = _plan_bwd_words(dev, B, F, H1, H2, O, T, rec, bf16, use_periods)
    if plan is None:
        raise ValueError(
            f"{k}: shape T={T} F={F} H1={H1} H2={H2} O={O} does not fit the "
            "kernel (gate on fused2_head_supported(training=True))")
    n_w0, n_w0r, n_w1, n_w1r, n_out = plan[:5]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    hw0, hw1 = (H1 + 31) // 32, (H2 + 31) // 32
    # Scratch of the call: each layer's dcur(t) per row and the bits of its
    # z per row (z0's with one mask row of padding at the end), and
    # dz0_in = dcur1 @ W1^T.
    dcur0 = torch.empty((B, T, H1), dtype=wdt, device=dev)
    dcur1 = torch.empty((B, T, H2), dtype=wdt, device=dev)
    zmask0 = torch.empty(((B * (T + 1) + 1) * hw0,), **i32)
    zmask1 = torch.empty((B, T + 1, hw1), **i32)
    dz0 = torch.empty((T, B, H1), **f32)
    slab_w0 = torch.empty((n_w0, F * H1), **f32)
    slab_w0r = torch.empty((n_w0r, H1 * H1), **f32)
    slab_w1 = torch.empty((n_w1, H1 * H2), **f32)
    slab_w1r = torch.empty((n_w1r, H2 * H2), **f32)
    slab_out = torch.empty((n_out, H2 * O + O), **f32)
    beta0_t, beta1_t = _f._beta_tensor(beta0, dev), _f._beta_tensor(beta1,
                                                                  dev)
    lib = _lib("fused2_bwd")
    p = _f._ptr
    rc = lib.snn_fused2_bwd(
        g_logits.data_ptr(), tstar.data_ptr(), p(g_cnt0), p(g_cnt1),
        d0.data_ptr(), p(a0), d1.data_ptr(), p(a1), lat.data_ptr(), p(w0r),
        w1.data_ptr(), p(w1r), w_out.data_ptr(), beta0_t.data_ptr(),
        beta1_t.data_ptr(), dcur0.data_ptr(),
        dcur1.data_ptr(), zmask0.data_ptr(), zmask1.data_ptr(),
        dz0.data_ptr(), slab_w0.data_ptr(), slab_w0r.data_ptr(),
        slab_w1.data_ptr(), slab_w1r.data_ptr(), slab_out.data_ptr(), B, F,
        H1, H2, O, T, int(use_periods), int(spike_func == SpikeFuncType.Phi),
        int(bf16), alpha, threshold, gamma, kappa, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    _f._launched_function(_f.KERNEL_GBITS, 1 + 2 * int(rec))
    _f._launched_function(_f.KERNEL_GZIN)
    gs = _f.gbits_sums
    sums = (gs(slab_w0r, None).view(H1, H1) if rec else None,
            gs(slab_w1, None).view(H1, H2),
            gs(slab_w1r, None).view(H2, H2) if rec else None)
    if keep is not None:
        keep.update(dcur0=dcur0, dcur1=dcur1, zmask0=zmask0, zmask1=zmask1,
                    dz0=dz0, g_w0r=sums[0], g_w1=sums[1], g_w1r=sums[2])
    w0r_g, w1_g, w1r_g = (None if x is None else x.to(wdt) for x in sums)
    out_sum = slab_out.sum(0)
    return (slab_w0.sum(0).view(F, H1).to(wdt), w0r_g, w1_g, w1r_g,
            out_sum[:H2 * O].view(H2, O).to(wdt), out_sum[H2 * O:].clone())


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _Fused2Fn(torch.autograd.Function):
    """The two-layer network with its backward.  Outputs: ``logits``, or
    ``(logits, cnt0, cnt1)``."""

    @staticmethod
    def forward(ctx, lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out,
                statics, want_counts, plain):
        (n_steps, use_periods, alif, alpha, rho, threshold, gamma, kappa,
         spike_func) = statics
        impl = _f._impl(lat, plain)
        fwd = _fused2_cuda if impl == "cuda" else _fused2_reference
        logits, d0, a0, d1, a1, tstar, cnt0, cnt1 = fwd(
            lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out, n_steps,
            use_periods, alif, alpha, rho, threshold, kappa, True,
            _f._stores_a(alif, spike_func), want_counts)
        ctx.impl, ctx.statics, ctx.betas = impl, statics, (beta0, beta1)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(lat, w0, w0r, w1, w1r, w_out, d0, a0, d1, a1,
                              tstar)
        if want_counts:
            return logits, cnt0, cnt1
        return logits

    @staticmethod
    def backward(ctx, g_logits, g_cnt0=None, g_cnt1=None):
        lat, w0, w0r, w1, w1r, w_out, d0, a0, d1, a1, tstar = ctx.saved_tensors
        (n_steps, use_periods, _, alpha, _, threshold, gamma, kappa,
         spike_func) = ctx.statics
        beta0, beta1 = ctx.betas
        if g_logits is None:
            g_logits = torch.zeros(tstar.shape, dtype=torch.float32,
                                   device=lat.device)
        g_logits = g_logits.to(torch.float32).contiguous()
        g_cnt0, g_cnt1 = (None if g is None
                          else g.to(torch.float32).contiguous()
                          for g in (g_cnt0, g_cnt1))
        bwd = (_fused2_bwd_cuda if ctx.impl == "cuda"
               else _fused2_bwd_reference)
        g_w0, g_w0r, g_w1, g_w1r, g_w_out, g_b = bwd(
            g_logits, g_cnt0, g_cnt1, tstar, d0, a0, d1, a1, lat, w0, w0r,
            beta0, w1, w1r, beta1, w_out, n_steps, use_periods, alpha,
            threshold, gamma, kappa, spike_func)
        return (None, g_w0, g_w0r, _f._zero_beta_grad(beta0), g_w1, g_w1r,
                _f._zero_beta_grad(beta1), g_w_out, g_b, None, None, None)


def _fused2(lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out, n_steps,
            use_periods, alif, alpha, rho, threshold, gamma, kappa,
            spike_func, want_counts, plain=False):
    scalars = (int(n_steps), bool(use_periods), bool(alif), float(alpha),
               float(rho), float(threshold))
    kappa = float(kappa)
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    if _f._wants_grad(w0, w0r, beta0, w1, w1r, beta1, w_out, b_out):
        statics = (*scalars, float(gamma), kappa, spike_func)
        out = _Fused2Fn.apply(lat, w0, w0r, beta0, w1, w1r, beta1, w_out,
                              b_out, statics, want_counts, plain)
        return (out[0], (out[1], out[2])) if want_counts else out
    fwd = (_fused2_cuda if _f._impl(lat, plain) == "cuda"
           else _fused2_reference)
    # Inference: no residual leaves the kernel (the counts variant runs the
    # training kernel with its traces off).
    out = fwd(lat, w0, w0r, beta0, w1, w1r, beta1, w_out, b_out, *scalars,
              kappa, False, False, want_counts)
    return (out[0], (out[6], out[7])) if want_counts else out[0]


def fused2_rec_head(
    latencies: torch.Tensor,
    w0: torch.Tensor,
    w0_rec: torch.Tensor,
    beta0: Beta,
    w1: torch.Tensor,
    w1_rec: torch.Tensor,
    beta1: Beta,
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
    """(latencies (B, F) int32, both hidden layers' weights with their
    masked recurrent weights, readout) -> logits (B, O), differentiable in
    the weights and the bias.  For LIF pass ``alif=False`` (the betas and
    ``rho`` are ignored)."""
    return _fused2(latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out,
                   b_out, n_steps, use_periods, alif, alpha, rho, threshold,
                   gamma, kappa, spike_func, False)


def fused2_ff_head(
    latencies: torch.Tensor,
    w0: torch.Tensor,
    beta0: Beta,
    w1: torch.Tensor,
    beta1: Beta,
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
    """Feedforward variant of :func:`fused2_rec_head`."""
    return _fused2(latencies, w0, None, beta0, w1, None, beta1, w_out, b_out,
                   n_steps, use_periods, alif, alpha, rho, threshold, gamma,
                   kappa, spike_func, False)


def fused2_rec_head_counts(
    latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out, b_out, n_steps,
    use_periods, alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, Counts]:
    """:func:`fused2_rec_head` that also returns both hidden layers'
    per-sample per-neuron spike counts: ``(logits, (cnt0 (B, H1), cnt1 (B,
    H2)))``, float32, differentiable in all three."""
    return _fused2(latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out,
                   b_out, n_steps, use_periods, alif, alpha, rho, threshold,
                   gamma, kappa, spike_func, True)


def fused2_ff_head_counts(
    latencies, w0, beta0, w1, beta1, w_out, b_out, n_steps, use_periods,
    alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, Counts]:
    """Feedforward variant of :func:`fused2_rec_head_counts`."""
    return _fused2(latencies, w0, None, beta0, w1, None, beta1, w_out, b_out,
                   n_steps, use_periods, alif, alpha, rho, threshold, gamma,
                   kappa, spike_func, True)


def fused2_rec_head_reference(
    latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out, b_out, n_steps,
    use_periods, alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """:func:`fused2_rec_head` through the plain PyTorch versions, forward
    and backward, on whatever device the tensors lie."""
    return _fused2(latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out,
                   b_out, n_steps, use_periods, alif, alpha, rho, threshold,
                   gamma, kappa, spike_func, False, plain=True)


def fused2_ff_head_reference(
    latencies, w0, beta0, w1, beta1, w_out, b_out, n_steps, use_periods,
    alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused2_ff_head`."""
    return _fused2(latencies, w0, None, beta0, w1, None, beta1, w_out, b_out,
                   n_steps, use_periods, alif, alpha, rho, threshold, gamma,
                   kappa, spike_func, False, plain=True)


def fused2_rec_head_counts_reference(
    latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out, b_out, n_steps,
    use_periods, alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, Counts]:
    """Plain PyTorch version of :func:`fused2_rec_head_counts`."""
    return _fused2(latencies, w0, w0_rec, beta0, w1, w1_rec, beta1, w_out,
                   b_out, n_steps, use_periods, alif, alpha, rho, threshold,
                   gamma, kappa, spike_func, True, plain=True)


def fused2_ff_head_counts_reference(
    latencies, w0, beta0, w1, beta1, w_out, b_out, n_steps, use_periods,
    alif, alpha, rho, threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, Counts]:
    """Plain PyTorch version of :func:`fused2_ff_head_counts`."""
    return _fused2(latencies, w0, None, beta0, w1, None, beta1, w_out, b_out,
                   n_steps, use_periods, alif, alpha, rho, threshold, gamma,
                   kappa, spike_func, True, plain=True)
