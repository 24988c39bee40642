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

Stacked replicas (an ensemble of S seeds on one shared batch, the JAX
package's stacked-replica mode, ``w_in.ndim == 3``): the head calls take
``W_in (S, F, H)``, ``W_rec (S, H, H)``, ``W_out (S, H, O)``, ``b_out (S,
O)`` and ``beta`` as a float or an ``(S,)`` tensor, and return logits ``(S,
B, O)``; one launch of ``fused_head_fwd_stacked`` (inference),
``fused_head_fwd_train_stacked`` and ``fused_head_bwd_stacked`` (training)
runs every replica, one block per (row tile, replica), each replica with the
single call's plan and arithmetic, so its results equal S single launches
bit for bit.  Their plain versions (``_head_stacked_reference`` and its
siblings) run the single plain version once per replica and stack.  No
caller of the stacked head asks for spike counts, so the ``_counts``
variants take single weights only.

Layer 0 of a deeper network is the same computation without the readout:
``fused_encode_{rec,ff}_scan`` return the spike trace ``z (T, B, H)`` in
the weights' dtype (JAX package: the ``head=False`` mode of the same two
kernels).  ``fused_layer0_fwd`` (``csrc/fused_head.cu``, the head kernels'
template with the readout compiled out, so its spikes are bitwise the
spikes inside the head) writes ``z`` and, for training, the residuals of
the JAX kernel: ``delta`` for ALIF with FastSigmoid, ``v`` for LIF, ``v``
and ``a`` for ALIF with Phi.  ``fused_layer0_bwd``
(``csrc/fused_layer0_bwd.cu``) runs the reverse chain from the cotangent
of ``z`` to ``g_W_in, g_W_rec``.
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
    "fused_encode_rec_scan",
    "fused_encode_ff_scan",
    "fused_encode_rec_scan_reference",
    "fused_encode_ff_scan_reference",
    "fused_supported",
    "launch_counts",
    "reset_launch_counts",
]

KERNEL = "fused_head_fwd"
KERNEL_TRAIN = "fused_head_fwd_train"
KERNEL_BWD = "fused_head_bwd"
KERNEL_L0 = "fused_layer0_fwd"
KERNEL_L0_BWD = "fused_layer0_bwd"
KERNEL_MID = "fused_mid_fwd"  # wrappers in ops/fused_mid.py
KERNEL_MID_BWD = "fused_mid_bwd"
# The two-hidden-layer kernel pair (wrappers in ops/fused2.py).
KERNEL_2 = "fused2_fwd"
KERNEL_2_TRAIN = "fused2_fwd_train"
KERNEL_2_BWD = "fused2_bwd"
# The Izhikevich kernels (wrappers in ops/fused_izh.py and ops/izh.py).
KERNEL_IZH = "fused_izh_fwd"
KERNEL_IZH_TRAIN = "fused_izh_fwd_train"
KERNEL_IZH_BWD = "fused_izh_bwd"
KERNEL_IZH_L0 = "fused_izh_layer0_fwd"
KERNEL_IZH_L0_BWD = "fused_izh_layer0_bwd"
KERNEL_IZH_SCAN = "izh_scan_fwd"
KERNEL_IZH_SCAN_BWD = "izh_scan_bwd"
# The unfused tier: encoded input product and recurrent scan over currents
# (wrappers in ops/encode.py and ops/rec_scan.py).
KERNEL_ENC = "encode_matmul_fwd"
KERNEL_ENC_BWD = "encode_matmul_bwd"
KERNEL_REC = "rec_scan_fwd"
KERNEL_REC_TRAIN = "rec_scan_fwd_train"
KERNEL_REC_BWD = "rec_scan_bwd"
# The feedforward scan over currents (wrappers in ops/scan.py).
KERNEL_SCAN = "scan_fwd"
KERNEL_SCAN_TRAIN = "scan_fwd_train"
KERNEL_SCAN_BWD = "scan_bwd"
# Stacked replicas of the whole-network heads (this module and
# ops/fused_izh.py): the same kernels with a replica grid axis.
STACKED = "_stacked"
KERNEL_STACKED = KERNEL + STACKED
KERNEL_TRAIN_STACKED = KERNEL_TRAIN + STACKED
KERNEL_BWD_STACKED = KERNEL_BWD + STACKED
KERNEL_IZH_STACKED = KERNEL_IZH + STACKED
KERNEL_IZH_TRAIN_STACKED = KERNEL_IZH_TRAIN + STACKED
KERNEL_IZH_BWD_STACKED = KERNEL_IZH_BWD + STACKED
MAX_STEPS = 32767  # the kernels stage latencies and steps as int16
MAX_REPLICAS = 65535  # the replica grid axis (y forward, z backward)
_counts_lock = threading.Lock()
_launches = {k: 0 for k in (
    KERNEL, KERNEL_TRAIN, KERNEL_BWD, KERNEL_L0, KERNEL_L0_BWD, KERNEL_MID,
    KERNEL_MID_BWD, KERNEL_2, KERNEL_2_TRAIN, KERNEL_2_BWD, KERNEL_IZH,
    KERNEL_IZH_TRAIN, KERNEL_IZH_BWD,
    KERNEL_IZH_L0, KERNEL_IZH_L0_BWD, KERNEL_IZH_SCAN, KERNEL_IZH_SCAN_BWD,
    KERNEL_ENC, KERNEL_ENC_BWD, KERNEL_REC, KERNEL_REC_TRAIN,
    KERNEL_REC_BWD, KERNEL_SCAN, KERNEL_SCAN_TRAIN, KERNEL_SCAN_BWD,
    KERNEL_STACKED, KERNEL_TRAIN_STACKED, KERNEL_BWD_STACKED,
    KERNEL_IZH_STACKED, KERNEL_IZH_TRAIN_STACKED, KERNEL_IZH_BWD_STACKED)}

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
def _residual_is_v(alif: bool, spike_func: SpikeFuncType) -> bool:
    """The z-emitting kernels keep the membrane ``v`` as their residual
    except for ALIF with FastSigmoid, whose surrogate needs ``delta = v -
    thr`` only; the heads always keep ``delta``."""
    return not (alif and spike_func == SpikeFuncType.FastSigmoid)


class _Cell:
    """One LIF/ALIF layer's state in the plain loops, stepped with the
    kernels' arithmetic in the kernels' order."""

    def __init__(self, n_rows, hidden, dev, w_rec, beta, alif, want_counts):
        f32 = torch.float32
        self.w_rec = None if w_rec is None else w_rec.to(f32)
        self.beta = (torch.as_tensor(beta, dtype=f32, device=dev) if alif
                     else None)
        self.v = torch.zeros((n_rows, hidden), dtype=f32, device=dev)
        self.a = torch.zeros_like(self.v)
        self.z = torch.zeros_like(self.v)
        self.counts = torch.zeros_like(self.v) if want_counts else None

    def step(self, cur, alpha, rho, threshold):
        """``v = (alpha v + cur + z_prev @ W_rec)(1 - z_prev)``, ``a = rho a
        + z_prev``, ``delta = v - (threshold + beta a)``, ``z = delta >=
        0``; returns ``delta``."""
        if self.w_rec is not None:
            cur = cur + self.z @ self.w_rec
        self.v = (alpha * self.v + cur) * (1.0 - self.z)
        if self.beta is not None:
            self.a = rho * self.a + self.z
            thr = threshold + self.beta * self.a
        else:
            thr = threshold
        delta = self.v - thr
        self.z = (delta >= 0).to(torch.float32)
        if self.counts is not None:
            self.counts = self.counts + self.z
        return delta


class _Readout:
    """The readout ``v = kappa v + z @ W_out + b`` and its running max with
    strict ``>`` (the first maximal step wins, as ``torch.max``); with
    ``track`` also the step of that max, ``tstar``."""

    def __init__(self, n_rows, w_out, b_out, kappa, dev):
        f32 = torch.float32
        self.w_out, self.b, self.kappa = w_out.to(f32), b_out.to(f32), kappa
        self.v = torch.zeros((n_rows, w_out.shape[1]), dtype=f32, device=dev)
        self.m = torch.full_like(self.v, float("-inf"))
        self.tstar = torch.zeros(self.v.shape, dtype=torch.int32, device=dev)

    def step(self, z, t, track):
        self.v = self.kappa * self.v + (z @ self.w_out + self.b)
        better = self.v > self.m
        self.m = torch.where(better, self.v, self.m)
        if track:
            self.tstar = torch.where(better, torch.full_like(self.tstar, t),
                                     self.tstar)


def _stack(trace):
    return torch.stack(trace) if trace else None


def _scan_loop(cur_in, n_rows, hidden, dev, wdtype, w_rec, beta, w_out,
               b_out, n_steps, alif, alpha, rho, threshold, kappa, train,
               store, store_a, want_counts, res_is_v=False):
    """Per-step loop with the kernels' arithmetic in the kernels' order.

    ``cur_in(t)`` is the float32 input current ``(B, H)`` of step ``t``.
    With ``w_out`` it is a head (readout, running max, no ``z`` leaves);
    without, the spike trace ``z (T, B, H)`` leaves in ``wdtype``.
    ``train`` tracks ``tstar``, ``store`` keeps the residual (and ``a``
    with ``store_a``), ``want_counts`` the spike counts.  Returns
    ``(logits, z, res, a, tstar, counts)`` with None for what the mode does
    not produce; the traces are rounded once to ``wdtype``.

    bf16 weights are upcast to float32 (exact), so every product with a
    0/1 spike is exact and every sum is float32.  On a CUDA device, run it
    with ``torch.backends.cuda.matmul.allow_tf32 = False``: TF32 would
    round float32 weights."""
    cell = _Cell(n_rows, hidden, dev, w_rec, beta, alif, want_counts)
    readout = (None if w_out is None
               else _Readout(n_rows, w_out, b_out, kappa, dev))
    zs, res, a_trace = [], [], []
    for t in range(n_steps):
        delta = cell.step(cur_in(t), alpha, rho, threshold)
        if readout is not None:
            readout.step(cell.z, t, train)
        else:
            zs.append(cell.z.to(wdtype))
        if store:  # rounded once, here
            res.append((cell.v if res_is_v else delta).to(wdtype))
            if store_a:
                a_trace.append(cell.a.to(wdtype))
    if readout is None:
        return None, _stack(zs), _stack(res), _stack(a_trace), None, \
            cell.counts
    return (readout.m, None, _stack(res), _stack(a_trace), readout.tstar,
            cell.counts)


def _latency_currents(lat, w_in, n_steps, use_periods):
    """``cur_in`` of :func:`_scan_loop` for an encoded first layer."""
    w_in32 = w_in.to(torch.float32)
    return lambda t: (spike_row(lat, t, n_steps, use_periods)
                      .to(torch.float32) @ w_in32)


def _head_loop(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods,
               alif, alpha, rho, threshold, kappa, train, store, store_a,
               want_counts):
    """The whole-network head through :func:`_scan_loop`."""
    m, _, delta, a_tr, tstar, counts = _scan_loop(
        _latency_currents(lat, w_in, n_steps, use_periods), lat.shape[0],
        w_in.shape[1], lat.device, w_in.dtype, w_rec, beta, w_out, b_out,
        n_steps, alif, alpha, rho, threshold, kappa, train, train and store,
        store_a, train and want_counts)
    if not train:
        return m
    return m, delta, a_tr, tstar, counts


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


def _layer0_reference(lat, w_in, w_rec, beta, n_steps, use_periods, alif,
                      alpha, rho, threshold, train, store_a, res_is_v):
    """Plain version of ``fused_layer0_fwd``: ``(z (T, B, H), res | None,
    a | None)`` in the weights' dtype; ``res`` is ``v`` or ``delta``."""
    _, z, res, a_tr, _, _ = _scan_loop(
        _latency_currents(lat, w_in, n_steps, use_periods), lat.shape[0],
        w_in.shape[1], lat.device, w_in.dtype, w_rec, beta, None, None,
        n_steps, alif, alpha, rho, threshold, 0.0, train, train, store_a,
        False, res_is_v)
    return z, res, a_tr


def _bwd_loop(spikes_in, w_in_t, g_logits, g_counts, tstar, g_z, res, a_tr,
              z, res_is_v, w_rec, beta, w_out, n_steps, alpha, threshold,
              gamma, kappa, spike_func, wd):
    """Plain version of the reverse-time kernels: an explicit loop from the
    residuals, rounding ``s`` and ``dcur`` through the weights' dtype
    ``wd`` before each product.

    A head (``w_out`` given) takes ``g_logits, tstar`` (and ``g_counts``)
    and recomputes ``z = res >= 0`` from its ``delta`` residual; a
    z-emitting layer takes ``g_z`` and the stored ``z``, and its residual
    is ``v`` where ``res_is_v``.  ``spikes_in(t)`` is the float32 0/1 input
    ``(B, F_in)`` of step ``t``; with ``w_in_t`` (``W_in^T`` as float32)
    the input's cotangent ``g_z_in (T, B, F_in)`` float32 is returned too.
    Returns ``(g_z_in | None, g_w_in, g_w_rec | None, g_w_out | None, g_b
    | None)``, all float32."""
    f32 = torch.float32
    head = w_out is not None
    dev = res.device
    _, B, H = res.shape

    def r(x):
        return x if wd == f32 else x.to(wd).to(f32)

    w_rec32 = None if w_rec is None else w_rec.to(f32)
    beta_t = (torch.as_tensor(beta, dtype=f32, device=dev)
              if a_tr is not None else None)
    dcur = torch.zeros((B, H), dtype=f32, device=dev)
    g_w_in = None
    g_w_rec = None if w_rec is None else torch.zeros((H, H), dtype=f32,
                                                     device=dev)
    g_w_out = g_b = None
    if head:
        w_out32 = w_out.to(f32)
        O = w_out.shape[1]
        g = g_logits.to(f32)
        s = torch.zeros((B, O), dtype=f32, device=dev)
        g_w_out = torch.zeros((H, O), dtype=f32, device=dev)
        g_b = torch.zeros((O,), dtype=f32, device=dev)
    g_z_in = [None] * n_steps if w_in_t is not None else None
    no_spikes = torch.zeros((B, H), dtype=f32, device=dev)
    for t in range(n_steps - 1, -1, -1):
        if head:
            s = kappa * s + g * (tstar == t).to(f32)
            s_r = r(s)
            dz = s_r @ w_out32.T
            if g_counts is not None:
                dz = dz + g_counts
        else:
            dz = g_z[t].to(f32)
        if w_rec32 is not None:
            dz = dz + r(dcur) @ w_rec32.T
        thr = (threshold + beta_t * a_tr[t].to(f32) if a_tr is not None
               else threshold)
        d_t = res[t].to(f32) - thr if res_is_v else res[t].to(f32)
        surr = surrogate_grad_from_delta(spike_func, d_t, thr, gamma)
        dv = dz * surr + alpha * dcur
        if t == 0:
            z_prev = no_spikes
        elif head:
            z_prev = (res[t - 1].to(f32) >= 0).to(f32)
        else:
            z_prev = z[t - 1].to(f32)
        dcur = dv * (1.0 - z_prev)
        dcr = r(dcur)
        # Input spikes at the forward step index of the dcur row they meet.
        part = spikes_in(t).T @ dcr
        g_w_in = part if g_w_in is None else g_w_in + part
        if g_z_in is not None:
            g_z_in[t] = dcr @ w_in_t
        if g_w_rec is not None:
            g_w_rec += z_prev.T @ dcr
        if head:
            g_w_out += (d_t >= 0).to(f32).T @ s_r
            g_b += s.sum(0)
    return (None if g_z_in is None else torch.stack(g_z_in), g_w_in, g_w_rec,
            g_w_out, g_b)


def _head_bwd_reference(g_logits, g_counts, tstar, delta, a_tr, lat, w_in,
                        w_rec, beta, w_out, n_steps, use_periods, alpha,
                        threshold, gamma, kappa, spike_func):
    """Plain version of ``fused_head_bwd``: ``(g_w_in, g_w_rec | None,
    g_w_out, g_b)``, the weights' gradients in the weights' dtype."""
    f32 = torch.float32
    _, g_w_in, g_w_rec, g_w_out, g_b = _bwd_loop(
        lambda t: spike_row(lat, t, n_steps, use_periods).to(f32), None,
        g_logits, g_counts, tstar, None, delta, a_tr, None, False, w_rec,
        beta, w_out, n_steps, alpha, threshold, gamma, kappa, spike_func,
        w_out.dtype)
    return (g_w_in.to(w_in.dtype),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype),
            g_w_out.to(w_out.dtype), g_b)


def replica_beta(beta: "Beta", s: int) -> "Beta":
    """Replica ``s``'s beta: a float is shared, a tensor holds one value a
    replica (a single value broadcasts, as the JAX kernel's
    ``broadcast_to(beta.reshape(-1, 1, 1), (S, 1, 1))``)."""
    if not isinstance(beta, torch.Tensor):
        return beta
    flat = beta.reshape(-1)
    return flat[s] if flat.numel() > 1 else flat[0]


def _stack_outs(outs):
    """Stack per-replica results: a tensor, or a tuple with Nones."""
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def _rec_at(w_rec, s):
    return None if w_rec is None else w_rec[s]


def _head_stacked_reference(lat, w_in, w_rec, beta, w_out, b_out, *rest):
    """Plain version of ``fused_head_fwd_stacked``: the single plain version
    once per replica, stacked -> logits ``(S, B, O)``."""
    return _stack_outs([
        _head_reference(lat, w_in[s], _rec_at(w_rec, s),
                        replica_beta(beta, s), w_out[s], b_out[s], *rest)
        for s in range(w_in.shape[0])])


def _head_train_stacked_reference(lat, w_in, w_rec, beta, w_out, b_out,
                                  *rest):
    """Plain version of ``fused_head_fwd_train_stacked``: as
    :func:`_head_train_reference` with a leading S on every output."""
    return _stack_outs([
        _head_train_reference(lat, w_in[s], _rec_at(w_rec, s),
                              replica_beta(beta, s), w_out[s], b_out[s],
                              *rest)
        for s in range(w_in.shape[0])])


def _head_bwd_stacked_reference(g_logits, g_counts, tstar, delta, a_tr, lat,
                                w_in, w_rec, beta, w_out, *rest):
    """Plain version of ``fused_head_bwd_stacked``: ``(g_w_in, g_w_rec |
    None, g_w_out, g_b)`` with a leading S."""
    if g_counts is not None:
        raise ValueError(f"{KERNEL_BWD_STACKED}: the stacked head has no "
                         "spike-count cotangent")
    return _stack_outs([
        _head_bwd_reference(g_logits[s], None, tstar[s], delta[s],
                            None if a_tr is None else a_tr[s], lat, w_in[s],
                            _rec_at(w_rec, s), replica_beta(beta, s),
                            w_out[s], *rest)
        for s in range(w_in.shape[0])])


def _layer0_bwd_reference(g_z, z, res, a_tr, res_is_v, lat, w_in, w_rec,
                          beta, n_steps, use_periods, alpha, threshold,
                          gamma, spike_func):
    """Plain version of ``fused_layer0_bwd``: ``(g_w_in, g_w_rec | None)``
    in the weights' dtype."""
    f32 = torch.float32
    _, g_w_in, g_w_rec, _, _ = _bwd_loop(
        lambda t: spike_row(lat, t, n_steps, use_periods).to(f32), None,
        None, None, None, g_z, res, a_tr, z, res_is_v, w_rec, beta, None,
        n_steps, alpha, threshold, gamma, 0.0, spike_func, w_in.dtype)
    return (g_w_in.to(w_in.dtype),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype))


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
            [vp] * 7 + [i] * 8 + [f] * 4 + [i] * 3 + [vp])
        lib.snn_fused_head_fwd.restype = i
        lib.snn_fused_head_fwd_train.argtypes = (
            [vp] * 11 + [i] * 8 + [f] * 4 + [i] * 3 + [vp])
        lib.snn_fused_head_fwd_train.restype = i
        lib.snn_fused_layer0_plan.argtypes = [i, i, i, i, i, ip, ip]
        lib.snn_fused_layer0_plan.restype = i
        lib.snn_fused_layer0_fwd.argtypes = (
            [vp] * 7 + [i] * 8 + [f] * 3 + [i, i, vp])
        lib.snn_fused_layer0_fwd.restype = i
    elif name == "fused_head_bwd":
        lib.snn_fused_head_bwd_plan.argtypes = [i] * 9 + [ip]
        lib.snn_fused_head_bwd_plan.restype = i
        lib.snn_fused_head_bwd.argtypes = (
            [vp] * 14 + [i] * 8 + [f] * 4 + [i, i, vp])
        lib.snn_fused_head_bwd.restype = i
    elif name == "fused_layer0_bwd":
        lib.snn_fused_layer0_bwd_plan.argtypes = [i] * 8 + [ip]
        lib.snn_fused_layer0_bwd_plan.restype = i
        lib.snn_fused_layer0_bwd.argtypes = (
            [vp] * 11 + [i] * 8 + [f] * 3 + [i, vp])
        lib.snn_fused_layer0_bwd.restype = i
    else:
        raise ValueError(f"no kernel source named {name!r}")
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


def _beta_tensor(beta: Beta, dev: torch.device,
                 n: int = 1) -> torch.Tensor:
    """``beta`` as ``n`` float32 values on ``dev`` (one a replica; a float
    or a single value is broadcast).  The caller holds the result until the
    launch is queued."""
    if isinstance(beta, torch.Tensor):
        flat = beta.detach().to(dev, torch.float32).reshape(-1)
        if flat.numel() not in (1, n):
            raise ValueError(f"beta must hold 1 or {n} values, got "
                             f"{flat.numel()}")
        return flat.expand(n).contiguous()
    return torch.full((n,), float(beta), dtype=torch.float32, device=dev)


def _replicas(w_in: torch.Tensor, kernel: str) -> Optional[int]:
    """S for stacked weights ``(S, F, H)``, None for a single network."""
    if w_in.dim() == 2:
        return None
    if w_in.dim() != 3 or not 1 <= w_in.shape[0] <= MAX_REPLICAS:
        raise ValueError(f"{kernel}: w_in must be (F, H) or (S, F, H) with "
                         f"1 <= S <= {MAX_REPLICAS}, got {tuple(w_in.shape)}")
    return w_in.shape[0]


def _lead(S: Optional[int]) -> tuple:
    return () if S is None else (S,)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_forward(kernel, lat, w_in, w_rec, w_out, b_out, n_steps,
                   S=None):
    """Validate the forward kernels' inputs (a leading S on the weights
    of ``S`` stacked replicas); returns (B, F, H, O, rows)."""
    dev = lat.device
    B, F = lat.shape
    H, O = w_in.shape[-1], w_out.shape[-1]
    wdt = w_in.dtype
    lead = _lead(S)
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: weights must be float32 or bfloat16, "
                         f"got {wdt}")
    _check(kernel, "latencies", lat, torch.int32, (B, F), dev)
    _check(kernel, "w_in", w_in, wdt, (*lead, F, H), dev)
    if w_rec is not None:
        _check(kernel, "w_rec", w_rec, wdt, (*lead, H, H), dev)
    _check(kernel, "w_out", w_out, wdt, (*lead, H, O), dev)
    _check(kernel, "b_out", b_out, torch.float32, (*lead, O), dev)
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
    """Launch ``fused_head_fwd`` (``fused_head_fwd_stacked`` for stacked
    weights)."""
    dev = lat.device
    S = _replicas(w_in, KERNEL)
    k = KERNEL if S is None else KERNEL_STACKED
    B, F, H, O, rows = _check_forward(k, lat, w_in, w_rec, w_out, b_out,
                                      n_steps, S)
    beta_t = _beta_tensor(beta, dev, S or 1)
    logits = torch.empty((*_lead(S), B, O), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.snn_fused_head_fwd(
        lat.data_ptr(), w_in.data_ptr(), _ptr(w_rec), beta_t.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), logits.data_ptr(), B, F, H, O,
        n_steps, int(use_periods), int(alif),
        int(w_in.dtype == torch.bfloat16), alpha, rho, threshold, kappa,
        rows, S or 1, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    return logits


def _head_train_cuda(lat, w_in, w_rec, beta, w_out, b_out, n_steps,
                     use_periods, alif, alpha, rho, threshold, kappa, store,
                     store_a, want_counts):
    """Launch ``fused_head_fwd_train`` (``fused_head_fwd_train_stacked``
    for stacked weights); returns as :func:`_head_train_reference`, with a
    leading S when stacked."""
    dev = lat.device
    S = _replicas(w_in, KERNEL_TRAIN)
    k = KERNEL_TRAIN if S is None else KERNEL_TRAIN_STACKED
    if S is not None and want_counts:
        raise ValueError(f"{k}: the stacked head has no spike counts")
    B, F, H, O, rows = _check_forward(k, lat, w_in, w_rec, w_out, b_out,
                                      n_steps, S)
    lead = _lead(S)
    beta_t = _beta_tensor(beta, dev, S or 1)
    logits = torch.empty((*lead, B, O), dtype=torch.float32, device=dev)
    tstar = torch.empty((*lead, B, O), dtype=torch.int32, device=dev)
    trace = dict(dtype=w_in.dtype, device=dev)
    delta = torch.empty((*lead, n_steps, B, H), **trace) if store else None
    a_tr = (torch.empty((*lead, n_steps, B, H), **trace)
            if store and store_a else None)
    counts = torch.empty((B, H), dtype=torch.float32, device=dev) \
        if want_counts else None
    lib = _lib()
    rc = lib.snn_fused_head_fwd_train(
        lat.data_ptr(), w_in.data_ptr(), _ptr(w_rec), beta_t.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), logits.data_ptr(), _ptr(delta),
        _ptr(a_tr), tstar.data_ptr(), _ptr(counts), B, F, H, O, n_steps,
        int(use_periods), int(alif), int(w_in.dtype == torch.bfloat16),
        alpha, rho, threshold, kappa, rows, S or 1, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    return logits, delta, a_tr, tstar, counts


def slab_sums(slab: torch.Tensor, S: Optional[int]) -> torch.Tensor:
    """The blocks' partial slabs ``([S,] blocks, n)`` added in a fixed
    order -> ``([S,] n)``.  Each replica's slabs are summed as a fresh
    ``(blocks, n)`` tensor, exactly as a single call's, so a stacked
    launch's gradients equal S single launches' bit for bit."""
    if S is None:
        return slab.sum(0)
    return torch.stack([slab[s].clone().sum(0) for s in range(S)])


def _head_bwd_cuda(g_logits, g_counts, tstar, delta, a_tr, lat, w_in, w_rec,
                   beta, w_out, n_steps, use_periods, alpha, threshold,
                   gamma, kappa, spike_func):
    """Launch ``fused_head_bwd`` (``fused_head_bwd_stacked`` for stacked
    weights; its four ``__global__`` functions in one call) and add the
    blocks' partial slabs in a fixed order."""
    dev = lat.device
    B, F = lat.shape
    H, O = w_out.shape[-2:]
    wdt = w_out.dtype
    S = _replicas(w_in, KERNEL_BWD)
    k = KERNEL_BWD if S is None else KERNEL_BWD_STACKED
    lead = _lead(S)
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{k}: weights must be float32 or bfloat16, "
                         f"got {wdt}")
    _check(k, "g_logits", g_logits, torch.float32, (*lead, B, O), dev)
    _check(k, "tstar", tstar, torch.int32, (*lead, B, O), dev)
    if g_counts is not None:
        if S is not None:
            raise ValueError(f"{k}: the stacked head has no spike-count "
                             "cotangent")
        _check(k, "g_counts", g_counts, torch.float32, (B, H), dev)
    _check(k, "delta", delta, wdt, (*lead, n_steps, B, H), dev)
    if a_tr is not None:
        _check(k, "a", a_tr, wdt, (*lead, n_steps, B, H), dev)
    _check(k, "latencies", lat, torch.int32, (B, F), dev)
    if w_rec is not None:
        _check(k, "w_rec", w_rec, wdt, (*lead, H, H), dev)
    _check(k, "w_out", w_out, wdt, (*lead, H, O), dev)
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
    dcur = torch.empty((*lead, B, n_steps, H), dtype=wdt, device=dev)
    zmask = torch.empty((*lead, B, n_steps + 1, (H + 31) // 32),
                        dtype=torch.int32, device=dev)
    slab_in = torch.empty((*lead, n_in, F * H), **f32)
    slab_rec = torch.empty((*lead, n_rec, H * H), **f32)
    slab_out = torch.empty((*lead, n_out, H * O + O), **f32)
    beta_t = _beta_tensor(beta, dev, S or 1)
    lib = _lib("fused_head_bwd")
    rc = lib.snn_fused_head_bwd(
        g_logits.data_ptr(), tstar.data_ptr(), _ptr(g_counts),
        delta.data_ptr(), _ptr(a_tr), lat.data_ptr(), _ptr(w_rec),
        w_out.data_ptr(), beta_t.data_ptr(),
        dcur.data_ptr(), zmask.data_ptr(), slab_in.data_ptr(),
        slab_rec.data_ptr(), slab_out.data_ptr(), B, F, H, O, n_steps,
        int(use_periods), int(spike_func == SpikeFuncType.Phi), int(bf16),
        alpha, threshold, gamma, kappa, S or 1, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    # The sum over the blocks' slabs lies outside the TPU kernel too.
    g_w_in = slab_sums(slab_in, S).view(*lead, F, H).to(w_in.dtype)
    g_w_rec = (None if w_rec is None
               else slab_sums(slab_rec, S).view(*lead, H, H).to(wdt))
    out_sum = slab_sums(slab_out, S)
    g_w_out = out_sum[..., :H * O].reshape(*lead, H, O).to(wdt)
    return g_w_in, g_w_rec, g_w_out, out_sum[..., H * O:].clone()


def _check_weights(kernel, w_in):
    if w_in.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: weights must be float32 or bfloat16, "
                         f"got {w_in.dtype}")


def _plan_layer0(device: torch.device, F: int, H: int, recurrent: bool,
                 bf16: bool) -> Optional[Tuple[int, int]]:
    """(rows per block, shared-memory bytes) of ``fused_layer0_fwd`` on
    ``device``, or None when the shape does not fit it."""
    lib = _lib()
    rows, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_fused_layer0_plan(F, H, int(recurrent), int(bf16),
                                   _index(device), ctypes.byref(rows),
                                   ctypes.byref(smem))
    if rc == 1:
        return None
    _raise_on(rc, lib, f"{KERNEL_L0} plan")
    return rows.value, smem.value


def _plan_layer0_bwd(device: torch.device, B: int, F: int, H: int, T: int,
                     recurrent: bool, bf16: bool,
                     use_periods: bool) -> Optional[Tuple[int, int]]:
    """Blocks of (g_W_in, g_W_rec) partial slabs of ``fused_layer0_bwd``
    on ``device``, or None when the shape does not fit."""
    lib = _lib("fused_layer0_bwd")
    out = (ctypes.c_int * 2)()
    rc = lib.snn_fused_layer0_bwd_plan(B, F, H, T, int(recurrent), int(bf16),
                                       int(use_periods), _index(device), out)
    if rc == 1:
        return None
    _raise_on(rc, lib, f"{KERNEL_L0_BWD} plan")
    return out[0], out[1]


def fused_supported(
    n_steps: int, n_features: int, hidden: int, recurrent: bool = True,
    itemsize: int = 4, device="cuda", training: bool = False,
    use_periods: bool = True,
) -> bool:
    """Whether the z-emitting first layer covers this shape on ``device``:
    the gates of :func:`fused_head_supported` without a readout."""
    device = torch.device(device)
    if n_steps < 1 or hidden < 1 or n_features < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    if _plan_layer0(device, n_features, hidden, recurrent,
                    itemsize == 2) is None:
        return False
    return not training or _plan_layer0_bwd(
        device, 1, n_features, hidden, n_steps, recurrent, itemsize == 2,
        use_periods) is not None


def _layer0_cuda(lat, w_in, w_rec, beta, n_steps, use_periods, alif, alpha,
                 rho, threshold, train, store_a, res_is_v):
    """Launch ``fused_layer0_fwd``; returns as :func:`_layer0_reference`."""
    k = KERNEL_L0
    dev = lat.device
    B, F = lat.shape
    H = w_in.shape[1]
    wdt = w_in.dtype
    _check_weights(k, w_in)
    _check(k, "latencies", lat, torch.int32, (B, F), dev)
    _check(k, "w_in", w_in, wdt, (F, H), dev)
    if w_rec is not None:
        _check(k, "w_rec", w_rec, wdt, (H, H), dev)
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(
            f"{k}: n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    plan = _plan_layer0(dev, F, H, w_rec is not None, wdt == torch.bfloat16)
    if plan is None:
        raise ValueError(f"{k}: shape F={F} H={H} does not fit the kernel "
                         "(gate on fused_supported)")
    trace = dict(dtype=wdt, device=dev)
    z = torch.empty((n_steps, B, H), **trace)
    res = torch.empty((n_steps, B, H), **trace) if train else None
    a_tr = torch.empty((n_steps, B, H), **trace) if train and store_a \
        else None
    lib = _lib()
    rc = lib.snn_fused_layer0_fwd(
        lat.data_ptr(), w_in.data_ptr(), _ptr(w_rec),
        _beta_tensor(beta, dev).data_ptr(), z.data_ptr(), _ptr(res),
        _ptr(a_tr), B, F, H, n_steps, int(use_periods), int(alif),
        int(wdt == torch.bfloat16), int(res_is_v), alpha, rho, threshold,
        plan[0], dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    return z, res, a_tr


def _layer0_bwd_cuda(g_z, z, res, a_tr, res_is_v, lat, w_in, w_rec, beta,
                     n_steps, use_periods, alpha, threshold, gamma,
                     spike_func):
    """Launch ``fused_layer0_bwd`` (chain, ``g_W_in`` and ``g_W_rec``
    functions in one call) and add the blocks' slabs in a fixed order."""
    k = KERNEL_L0_BWD
    dev = lat.device
    B, F = lat.shape
    H = w_in.shape[1]
    wdt = w_in.dtype
    _check_weights(k, w_in)
    for name, t in (("g_z", g_z), ("z", z), ("res", res), ("a", a_tr)):
        if t is not None:
            _check(k, name, t, wdt, (n_steps, B, H), dev)
    _check(k, "latencies", lat, torch.int32, (B, F), dev)
    if w_rec is not None:
        _check(k, "w_rec", w_rec, wdt, (H, H), dev)
    bf16 = wdt == torch.bfloat16
    plan = _plan_layer0_bwd(dev, B, F, H, n_steps, w_rec is not None, bf16,
                            use_periods)
    if plan is None:
        raise ValueError(
            f"{k}: shape T={n_steps} F={F} H={H} does not fit the kernel "
            "(gate on fused_supported(training=True))")
    n_in, n_rec = plan
    f32 = dict(dtype=torch.float32, device=dev)
    dcur = torch.empty((B, n_steps, H), dtype=wdt, device=dev)
    zmask = torch.empty((B, n_steps + 1, (H + 31) // 32), dtype=torch.int32,
                        device=dev)
    slab_in = torch.empty((n_in, F * H), **f32)
    slab_rec = torch.empty((n_rec, H * H), **f32)
    lib = _lib("fused_layer0_bwd")
    rc = lib.snn_fused_layer0_bwd(
        g_z.data_ptr(), z.data_ptr(), res.data_ptr(), _ptr(a_tr),
        lat.data_ptr(), _ptr(w_rec), _beta_tensor(beta, dev).data_ptr(),
        dcur.data_ptr(), zmask.data_ptr(), slab_in.data_ptr(),
        slab_rec.data_ptr(), B, F, H, n_steps, int(use_periods),
        int(spike_func == SpikeFuncType.Phi), int(bf16), int(res_is_v),
        alpha, threshold, gamma, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, f"{k} launch")
    _launched(k)
    g_w_in = slab_in.sum(0).view(F, H).to(wdt)
    g_w_rec = (None if w_rec is None
               else slab_rec.sum(0).view(H, H).to(wdt))
    return g_w_in, g_w_rec


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
        fwd = (_head_train_cuda if impl == "cuda"
               else _head_train_stacked_reference if w_in.dim() == 3
               else _head_train_reference)
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
        bwd = (_head_bwd_cuda if ctx.impl == "cuda"
               else _head_bwd_stacked_reference if w_in.dim() == 3
               else _head_bwd_reference)
        g_w_in, g_w_rec, g_w_out, g_b = bwd(
            g_logits, g_counts, tstar, delta, a_tr, lat, w_in, w_rec,
            ctx.beta, w_out, n_steps, use_periods, alpha, threshold, gamma,
            kappa, spike_func)
        return (None, g_w_in, g_w_rec, _zero_beta_grad(ctx.beta), g_w_out,
                g_b, None, None, None)


def _head(lat, w_in, w_rec, beta, w_out, b_out, n_steps, use_periods, alif,
          alpha, rho, threshold, gamma, kappa, spike_func, want_counts,
          plain=False):
    scalars = (int(n_steps), bool(use_periods), bool(alif), float(alpha),
               float(rho), float(threshold))
    kappa = float(kappa)
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    stacked = _replicas(w_in, KERNEL) is not None
    if stacked and want_counts:
        raise ValueError("the stacked head has no _counts variant (no "
                         "ensemble trains with a spike regularizer)")
    if _wants_grad(w_in, w_rec, beta, w_out, b_out):
        statics = (*scalars, float(gamma), kappa, spike_func)
        return _HeadFn.apply(lat, w_in, w_rec, beta, w_out, b_out, statics,
                             want_counts, plain)
    cuda = _impl(lat, plain) == "cuda"
    args = (lat, w_in, w_rec, beta, w_out, b_out, *scalars, kappa)
    if not want_counts:  # inference: no residual leaves the kernel
        return (_head_cuda if cuda
                else _head_stacked_reference if stacked
                else _head_reference)(*args)
    fwd = _head_train_cuda if cuda else _head_train_reference
    logits, _, _, _, counts = fwd(*args, False, False, True)
    return logits, counts


def _zero_beta_grad(beta):
    """No gradient reaches beta: it enters only through the threshold."""
    if isinstance(beta, torch.Tensor) and beta.requires_grad:
        return torch.zeros_like(beta)
    return None


class _Layer0Fn(torch.autograd.Function):
    """The z-emitting first layer with its backward."""

    @staticmethod
    def forward(ctx, lat, w_in, w_rec, beta, statics, plain):
        (n_steps, use_periods, alif, alpha, rho, threshold, gamma,
         spike_func) = statics
        impl = _impl(lat, plain)
        fwd = _layer0_cuda if impl == "cuda" else _layer0_reference
        res_is_v = _residual_is_v(alif, spike_func)
        z, res, a_tr = fwd(lat, w_in, w_rec, beta, n_steps, use_periods,
                           alif, alpha, rho, threshold, True,
                           _stores_a(alif, spike_func), res_is_v)
        ctx.impl, ctx.statics, ctx.beta, ctx.res_is_v = (impl, statics, beta,
                                                         res_is_v)
        ctx.save_for_backward(lat, w_in, w_rec, z, res, a_tr)
        return z

    @staticmethod
    def backward(ctx, g_z):
        lat, w_in, w_rec, z, res, a_tr = ctx.saved_tensors
        (n_steps, use_periods, _, alpha, _, threshold, gamma,
         spike_func) = ctx.statics
        g_z = g_z.to(z.dtype).contiguous()
        bwd = (_layer0_bwd_cuda if ctx.impl == "cuda"
               else _layer0_bwd_reference)
        g_w_in, g_w_rec = bwd(g_z, z, res, a_tr, ctx.res_is_v, lat, w_in,
                              w_rec, ctx.beta, n_steps, use_periods, alpha,
                              threshold, gamma, spike_func)
        return None, g_w_in, g_w_rec, _zero_beta_grad(ctx.beta), None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _layer0(lat, w_in, w_rec, beta, n_steps, use_periods, alif, alpha, rho,
            threshold, gamma, spike_func, plain=False):
    scalars = (int(n_steps), bool(use_periods), bool(alif), float(alpha),
               float(rho), float(threshold))
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    if _wants_grad(w_in, w_rec, beta):
        return _Layer0Fn.apply(lat, w_in, w_rec, beta,
                               (*scalars, float(gamma), spike_func), plain)
    fwd = (_layer0_cuda if _impl(lat, plain) == "cuda"
           else _layer0_reference)
    # Inference: only the spike trace leaves.
    return fwd(lat, w_in, w_rec, beta, *scalars, False, False, False)[0]


def fused_encode_rec_scan(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: torch.Tensor,
    beta: Beta,
    n_steps: int,
    use_periods: bool,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """(latencies (B, F) int32, W_in, masked W_rec) -> spikes ``(T, B, H)``
    in the weights' dtype, differentiable in the weights: encoding, input
    product and the recurrent LIF/ALIF scan of a deeper network's first
    layer in one call."""
    return _layer0(latencies, w_in, w_rec, beta, n_steps, use_periods, alif,
                   alpha, rho, threshold, gamma, spike_func)


def fused_encode_ff_scan(
    latencies: torch.Tensor,
    w_in: torch.Tensor,
    beta: Beta,
    n_steps: int,
    use_periods: bool,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Feedforward variant: no recurrent weights."""
    return _layer0(latencies, w_in, None, beta, n_steps, use_periods, alif,
                   alpha, rho, threshold, gamma, spike_func)


def fused_encode_rec_scan_reference(
    latencies, w_in, w_rec, beta, n_steps, use_periods, alif, alpha, rho,
    threshold, gamma,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """:func:`fused_encode_rec_scan` through the plain PyTorch versions,
    forward and backward, on whatever device the tensors lie."""
    return _layer0(latencies, w_in, w_rec, beta, n_steps, use_periods, alif,
                   alpha, rho, threshold, gamma, spike_func, plain=True)


def fused_encode_ff_scan_reference(
    latencies, w_in, beta, n_steps, use_periods, alif, alpha, rho, threshold,
    gamma, spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encode_ff_scan`."""
    return _layer0(latencies, w_in, None, beta, n_steps, use_periods, alif,
                   alpha, rho, threshold, gamma, spike_func, plain=True)


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
    ``gamma`` and ``spike_func`` shape the surrogate gradient only.
    Stacked weights (``W_in (S, F, H)`` and a leading S on every weight and
    on ``b_out``; ``beta`` a float or ``(S,)``) run S replicas on the same
    latencies in one launch and return ``(S, B, O)``."""
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
    """Feedforward variant: no recurrent weights (stacked weights as
    :func:`fused_encode_rec_scan_head`)."""
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
