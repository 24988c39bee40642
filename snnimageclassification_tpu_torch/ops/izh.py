"""Izhikevich scan over precomputed input currents, forward and backward.

Port of the JAX package's ops/pallas_izh.py: ``izh_scan(currents (T, B, H)
float32, masked W_rec | None, ...) -> spikes (T, B, H)``, differentiable in
the currents and ``W_rec``.  A hidden Izhikevich layer past the first runs
it on the currents ``z_in @ W_in`` of all steps (models/snn.py:apply).

Dynamics (ops/cells.py ``izhikevich_step``), ``r = z(t-1)``, v starting at
``v_rest``, u and z at zero:

    cur  = i(t) (+ z(t-1) @ W_rec)
    v'   = (v + dt (k (v - v_rest)(v - v_th) - u + cur) / C)(1 - r) + c r
    u'   = (u + dt a (b (v - v_rest) - u)) + d r
    z    = [v' >= v_peak]        (surrogate gradient in v only)

The backward carries two cotangents, dv and du (the derivation is in the
JAX module's docstring and in ``csrc/izh_common.cuh``); its residuals are
the float32 ``z`` and ``v`` traces.

Two hand-written CUDA kernels stand behind :func:`izh_scan`
(``csrc/izh_scan.cu``): ``izh_scan_fwd`` and ``izh_scan_bwd`` (the chain,
then ``g_W_rec`` as a sum over spike bits, ``gbits_mma``).  Where the shape
fits (H <= 256, W_rec's bf16 pieces within a block's shared memory) both
run the tensor-core bodies of the first layers: the forward
``head_mma_kernel`` with the Izhikevich cell and the currents as its input
(``csrc/head_mma_fwd.cuh:DenseCurrent``), the chain
``bwd_chain_mma_kernel`` with ``csrc/izh_chain.cuh:IzhScanChain``;
other shapes the per-unit kernels.  :func:`scan_bodies` names the bodies,
:func:`gradient_plan` gives the backward's order;
:func:`_scan_ordered_reference` and :func:`_scan_bwd_ordered_reference`
are the plain versions in the tensor-core bodies' summation order (the
forward's bit for bit on the card).  On a CUDA tensor the wrapper
launches the kernels or raises; on the CPU it runs the order-free plain
PyTorch versions (``_scan_reference``, ``_scan_bwd_reference``), which
the tests hold against the JAX kernels.  :func:`izh_scan_reference` runs
the plain versions on any device.  The plain loops here
(:func:`_izh_loop`, :func:`_izh_bwd_loop`) also serve the encoded
Izhikevich calls of ops/fused_izh.py.

Rounding: currents, state and traces are float32; ``W_rec`` may be
bfloat16, with ``z`` (exact) and the backward's ``gi`` rounded to it before
each product; ``(dt * dvdt) / C`` is a true division on every device (a
device tensor divides, not a Python scalar, which PyTorch's CUDA division
would turn into a multiplication by the reciprocal).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused as _f
from .fused import KERNEL_IZH_SCAN, KERNEL_IZH_SCAN_BWD, MAX_STEPS
from .surrogate import SpikeFuncType, surrogate_grad_from_delta

__all__ = [
    "gradient_plan",
    "izh_kernel_params",
    "izh_scan",
    "izh_scan_reference",
    "izh_scan_supported",
    "scan_bodies",
]

_NAMES = ("dt", "C", "v_rest", "v_th", "k", "a", "b", "c", "d", "v_peak")


def izh_kernel_params(lcfg) -> tuple:
    """Hashable dynamics-constant tuple from an ``IzhikevichConfig``, as the
    JAX package's ``pallas_izh.izh_kernel_params``."""
    return tuple((n, getattr(lcfg, n)) for n in _NAMES)


def _consts(kernel_params) -> list:
    """The ten constants in the kernels' argument order."""
    p = dict(kernel_params)
    return [float(p[n]) for n in _NAMES]


def _bwd_consts(kernel_params) -> list:
    """dt/C, dt k/C, dt a b, 1 - dt a (double, rounded once to float by the
    caller, as the JAX kernel's Python constants) and v_rest, v_th,
    v_peak."""
    p = dict(kernel_params)
    dt, C = p["dt"], p["C"]
    return [dt / C, dt * p["k"] / C, dt * p["a"] * p["b"], 1.0 - dt * p["a"],
            p["v_rest"], p["v_th"], p["v_peak"]]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _cell_step(kernel_params, dev):
    """``step(v, u, z, cur) -> (v, u, z)``: one step of the cell from the
    float32 input current ``cur`` and ``z = z(t-1)``, the kernels'
    arithmetic in their order (``csrc/izh_common.cuh:izh_step``)."""
    p = dict(kernel_params)
    # A tensor divisor: a true division on every device.
    C = torch.full((), p["C"], dtype=torch.float32, device=dev)

    def step(v, u, z, cur):
        dvdt = p["k"] * (v - p["v_rest"]) * (v - p["v_th"]) - u + cur
        v_new = (v + p["dt"] * dvdt / C) * (1.0 - z) + p["c"] * z
        dudt = p["a"] * (p["b"] * (v - p["v_rest"]) - u)
        u = (u + p["dt"] * dudt) + p["d"] * z
        return v_new, u, (v_new >= p["v_peak"]).to(torch.float32)

    return step


def _izh_loop(cur_in, n_rows, hidden, dev, w_rec, n_steps, kernel_params,
              w_out=None, b_out=None, kappa=0.0, keep_z=False, keep_v=False,
              train=False, want_counts=False):
    """Per-step loop with the kernels' arithmetic in the kernels' order.

    ``cur_in(t)`` is the float32 input current ``(B, H)`` of step ``t``.
    With ``w_out`` a readout ``v_r = kappa v_r + (z @ W_out + b)`` and a
    running max with strict ``>`` follow (``train`` tracks its step).
    Returns ``(logits, z, v, tstar, counts)``, None for what was not asked:
    ``keep_z``/``keep_v`` stack the float32 traces.  bf16 weights are
    upcast (exact), so products with 0/1 spikes are exact and sums float32;
    on a card run it with ``torch.backends.cuda.matmul.allow_tf32 =
    False``."""
    f32 = torch.float32
    p = dict(kernel_params)
    step = _cell_step(kernel_params, dev)
    w_rec32 = None if w_rec is None else w_rec.to(f32)
    v = torch.full((n_rows, hidden), p["v_rest"], dtype=f32, device=dev)
    u = torch.zeros_like(v)
    z = torch.zeros_like(v)
    counts = torch.zeros_like(v) if want_counts else None
    m = tstar = None
    if w_out is not None:
        w_out32, b = w_out.to(f32), b_out.to(f32)
        n_out = w_out.shape[1]
        v_r = torch.zeros((n_rows, n_out), dtype=f32, device=dev)
        m = torch.full((n_rows, n_out), float("-inf"), dtype=f32, device=dev)
        tstar = torch.zeros((n_rows, n_out), dtype=torch.int32, device=dev)
    zs, vs = [], []
    for t in range(n_steps):
        cur = cur_in(t)
        if w_rec32 is not None:
            cur = cur + z @ w_rec32
        v, u, z = step(v, u, z, cur)
        if w_out is not None:
            v_r = kappa * v_r + (z @ w_out32 + b)
            better = v_r > m
            m = torch.where(better, v_r, m)
            if train:
                tstar = torch.where(better, torch.full_like(tstar, t), tstar)
        if counts is not None:
            counts = counts + z
        if keep_z:
            zs.append(z)
        if keep_v:
            vs.append(v)
    return (m, torch.stack(zs) if keep_z else None,
            torch.stack(vs) if keep_v else None,
            tstar if train else None, counts)


def _izh_bwd_loop(spikes_in, g_logits, g_counts, tstar, g_z, v, z, w_rec,
                  w_out, kernel_params, gamma, kappa, spike_func, wd,
                  want_gi=False, gi_out=None, matmul=None):
    """Plain version of the reverse-time Izhikevich kernels from the float32
    ``v`` (and, for a z-emitting layer, ``z``) traces.

    A head (``w_out`` given) takes ``g_logits, tstar`` (and ``g_counts``)
    and recomputes ``z = v >= v_peak``; a z-emitting layer takes ``g_z``.
    ``spikes_in(t)``, when given, is the float32 0/1 input ``(B, F)`` of
    step ``t`` for ``g_W_in``.  ``gi`` (the input current's cotangent) is
    rounded through ``wd`` before every product.  Returns ``(g_i (T, B, H)
    float32 | None, g_w_in | None, g_w_rec | None, g_w_out | None, g_b |
    None)``, all float32.  A ``gi_out (B, T, H)`` float32 tensor, where
    given, receives ``gi`` rounded through ``wd``, as the kernels' chain
    writes it for their gradient functions; ``matmul(a, w)``, where given,
    forms the two dense products ``s @ W_out^T`` and ``gi(t+1) @ W_rec^T``
    in place of ``@``."""
    f32 = torch.float32
    dtC, c1, c2, c3, v_rest, v_th, v_peak = _bwd_consts(kernel_params)
    head = w_out is not None
    T, B, H = v.shape
    dev = v.device

    def r(x):
        return x if wd == f32 else x.to(wd).to(f32)

    mm = matmul or torch.matmul

    def z_at(t):
        if t < 0:
            return torch.zeros((B, H), dtype=f32, device=dev)
        return (v[t] >= v_peak).to(f32) if head else z[t].to(f32)

    w_rec32 = None if w_rec is None else w_rec.to(f32)
    g_w_in = g_w_out = g_b = None
    g_w_rec = None if w_rec is None else torch.zeros((H, H), dtype=f32,
                                                     device=dev)
    if head:
        w_out32 = w_out.to(f32)
        g = g_logits.to(f32)
        s = torch.zeros(tuple(g.shape), dtype=f32, device=dev)
        g_w_out = torch.zeros(tuple(w_out.shape), dtype=f32, device=dev)
        g_b = torch.zeros((w_out.shape[1],), dtype=f32, device=dev)
    gis = [None] * T if want_gi else None
    dv_next = torch.zeros((B, H), dtype=f32, device=dev)
    du_next = torch.zeros_like(dv_next)
    z_t = z_at(T - 1)
    for t in range(T - 1, -1, -1):
        v_t = v[t]
        nr = 1.0 - z_t
        dcur_next = dv_next * dtC * nr
        if head:
            s = kappa * s + g * (tstar == t).to(f32)
            s_r = r(s)
            dz = mm(s_r, w_out32.T)
            if g_counts is not None:
                dz = dz + g_counts
        else:
            dz = g_z[t].to(f32)
        if w_rec32 is not None:
            dz = dz + mm(r(dcur_next), w_rec32.T)
        surr = surrogate_grad_from_delta(spike_func, v_t - v_peak, v_peak,
                                         gamma)
        dv = (dz * surr
              + dv_next * (1.0 + c1 * (2.0 * v_t - v_rest - v_th)) * nr
              + du_next * c2)
        du = -dcur_next + du_next * c3
        z_prev = z_at(t - 1)
        gi = dv * dtC * (1.0 - z_prev)
        if gis is not None:
            gis[t] = gi
        gr = r(gi)
        if gi_out is not None:
            gi_out[:, t] = gr
        if spikes_in is not None:
            part = spikes_in(t).T @ gr
            g_w_in = part if g_w_in is None else g_w_in + part
        if g_w_rec is not None:
            g_w_rec += z_prev.T @ gr
        if head:
            g_w_out += z_t.T @ s_r
            g_b += s.sum(0)
        dv_next, du_next, z_t = dv, du, z_prev
    return (None if gis is None else torch.stack(gis), g_w_in, g_w_rec,
            g_w_out, g_b)


def _scan_reference(currents, w_rec, kernel_params, train):
    """Plain version of ``izh_scan_fwd``: ``(z, v | None)`` float32."""
    T, B, H = currents.shape
    _, z, v, _, _ = _izh_loop(lambda t: currents[t].to(torch.float32), B, H,
                              currents.device, w_rec, T, kernel_params,
                              keep_z=True, keep_v=train)
    return z, v


def _scan_bwd_reference(g_z, z, v, w_rec, kernel_params, gamma, spike_func):
    """Plain version of ``izh_scan_bwd``: ``(g_i (T, B, H) float32, g_w_rec
    | None in W_rec's dtype)``."""
    wd = torch.float32 if w_rec is None else w_rec.dtype
    g_i, _, g_w_rec, _, _ = _izh_bwd_loop(
        None, None, None, None, g_z, v, z, w_rec, None, kernel_params,
        gamma, 0.0, spike_func, wd, want_gi=True)
    return g_i, None if g_w_rec is None else g_w_rec.to(w_rec.dtype)


def _scan_ordered_reference(currents, w_rec, kernel_params, train):
    """Plain version of ``izh_scan_fwd``'s tensor-core body
    (``csrc/head_mma_fwd.cuh:mma_layer`` with the Izhikevich cell and the
    currents as its input) in its summation order: at each step the
    current ``cur(t)`` plus, past step 0, ``z(t-1) @ W_rec`` k16-sliced as
    the body forms it (``ops/fused.py:_slice_product`` on the weights'
    pieces), in that order, then the cell step of :func:`_cell_step`.
    Returns as :func:`_scan_reference`."""
    f32 = torch.float32
    T, B, H = currents.shape
    dev = currents.device
    step = _cell_step(kernel_params, dev)
    rec_p = None if w_rec is None else _f._weight_pieces(w_rec)
    v = torch.full((B, H), dict(kernel_params)["v_rest"], dtype=f32,
                   device=dev)
    u = torch.zeros_like(v)
    z = torch.zeros_like(v)
    zs, vs = [], []
    for t in range(T):
        cur = currents[t].to(f32)
        if rec_p is not None and t > 0:
            cur = cur + _f._slice_product(z, rec_p)
        v, u, z = step(v, u, z, cur)
        zs.append(z)
        if train:
            vs.append(v)
    return torch.stack(zs), torch.stack(vs) if train else None


def _scan_bwd_ordered_reference(g_z, z, v, w_rec, kernel_params, gamma,
                                spike_func, order, keep=None):
    """Plain version of ``izh_scan_bwd`` in its order: the two-carry chain
    with the tensor-core chain body's product ``round(gi(t+1)) @ W_rec^T``
    (``ops/fused.py:_split_slice_product``), then ``g_W_rec`` from the
    chain's ``g_i`` through ``gbits._gbits_ordered_reference`` (the plan's
    row groups, ``order`` of :func:`gradient_plan`; g_i read step-major,
    as ``gbits_mma`` reads it).  Returns as
    :func:`_scan_bwd_reference`; a dict ``keep`` receives ``g_w_rec``, the
    float32 sum before its cast."""
    from .gbits import _gbits_ordered_reference

    f32 = torch.float32
    wd = f32 if w_rec is None else w_rec.dtype
    g_i, _, _, _, _ = _izh_bwd_loop(
        None, None, None, None, g_z, v, z, w_rec, None, kernel_params,
        gamma, 0.0, spike_func, wd, want_gi=True,
        matmul=lambda a, w: _f._split_slice_product(a, w.contiguous(), wd))
    if w_rec is None:
        return g_i, None
    T, B, H = v.shape
    zf = z.to(f32)
    z_prev = torch.cat([torch.zeros_like(zf[:1]), zf[:-1]])
    g_w_rec = _gbits_ordered_reference(
        g_i.reshape(T * B, H), z_prev.reshape(T * B, H), B, T,
        order["groups_rec"], wd, step_major=True)
    if keep is not None:
        keep["g_w_rec"] = g_w_rec
    return g_i, g_w_rec.to(w_rec.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.snn_izh_scan_plan.argtypes = [i] * 4 + [ip, ip, ip]
    lib.snn_izh_scan_plan.restype = i
    lib.snn_izh_scan_fwd.argtypes = (
        [vp] * 4 + [i] * 4 + [f] * 10 + [i, i, i, vp])
    lib.snn_izh_scan_fwd.restype = i
    lib.snn_izh_scan_bwd_plan.argtypes = [i] * 6 + [ip]
    lib.snn_izh_scan_bwd_plan.restype = i
    lib.snn_izh_scan_bwd.argtypes = [vp] * 7 + [i] * 5 + [f] * 8 + [i, vp]
    lib.snn_izh_scan_bwd.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("izh_scan")
    if not getattr(lib, "_snn_declared", False):
        _declare(lib)
    return lib


def _plan(device: torch.device, H: int, recurrent: bool,
          bf16: bool) -> Optional[Tuple[int, int, bool]]:
    """(rows per block, shared-memory bytes, tensor-core body) of
    ``izh_scan_fwd``: the tensor-core body where the third is True, else
    the per-unit body at those rows and bytes; None when the shape does
    not fit."""
    lib = _lib()
    rows, smem, mma = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_izh_scan_plan(H, int(recurrent), int(bf16),
                               _f._index(device), ctypes.byref(rows),
                               ctypes.byref(smem), ctypes.byref(mma))
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_IZH_SCAN} plan")
    return rows.value, smem.value, bool(mma.value)


def _plan_bwd_words(device: torch.device, B: int, H: int, T: int,
                    recurrent: bool, bf16: bool) -> Optional[list]:
    """``snn_izh_scan_bwd_plan``'s words (blocks of ``g_W_rec`` slabs, 0
    without recurrence; 1 where the chain takes the tensor-core chain
    body), or None when the shape does not fit."""
    lib = _lib()
    out = (ctypes.c_int * 2)()
    rc = lib.snn_izh_scan_bwd_plan(B, H, T, int(recurrent), int(bf16),
                                   _f._index(device), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_IZH_SCAN_BWD} plan")
    return list(out)


def _plan_bwd(device: torch.device, B: int, H: int, T: int, recurrent: bool,
              bf16: bool) -> Optional[int]:
    """Blocks of ``g_W_rec`` slabs of ``izh_scan_bwd`` (0 without
    recurrence), or None when the shape does not fit."""
    out = _plan_bwd_words(device, B, H, T, recurrent, bf16)
    return None if out is None else out[0]


def gradient_plan(device, B: int, H: int, T: int, recurrent: bool,
                  bf16: bool) -> dict:
    """The order of ``izh_scan_bwd`` on ``device`` for a shape:
    ``groups_rec``, blocks of ``gbits_mma`` (0 without recurrence),
    and ``mma``, whether the chain takes the tensor-core chain body.
    :func:`_scan_bwd_ordered_reference` takes it."""
    out = _plan_bwd_words(torch.device(device), B, H, T, recurrent, bf16)
    if out is None:
        raise ValueError(f"{KERNEL_IZH_SCAN_BWD}: shape T={T} H={H} does "
                         "not fit the kernel")
    return dict(groups_rec=out[0], mma=bool(out[1]))


def scan_bodies(n_steps: int, hidden: int, recurrent: bool = True,
                itemsize: int = 4, device="cuda",
                training: bool = False) -> Tuple[str, ...]:
    """The body each scan kernel runs a shape on, for a shape
    :func:`izh_scan_supported` takes: ``"mma"`` (``izh_scan_fwd`` on the
    first layers' tensor-core body, ``csrc/head_mma_fwd.cuh``) or
    ``"per-unit"`` (H > 256, or W_rec's bf16 pieces past a block's shared
    memory: float32 recurrent from H = 161); a second entry with
    ``training``: ``izh_scan_bwd``'s chain, ``"mma"`` on the tensor-core
    chain body (``csrc/chain_mma.cuh``) or ``"per-unit"`` past the same
    limits.  On the CPU the plain versions: ``"plain"`` entries."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("plain",) * (1 + int(training))
    bf16 = itemsize == 2
    fwd = _plan(device, hidden, recurrent, bf16)
    out = ("mma" if fwd and fwd[2] else "per-unit",)
    if training:
        bwd = _plan_bwd_words(device, 1, hidden, n_steps, recurrent, bf16)
        out += ("mma" if bwd and bwd[1] else "per-unit",)
    return out


def izh_scan_supported(n_steps: int, hidden: int, recurrent: bool = True,
                       itemsize: int = 4, device="cuda",
                       training: bool = False) -> bool:
    """Whether :func:`izh_scan` covers this shape on ``device``.  On the CPU
    the plain versions cover every shape.  On a CUDA device the kernels need
    ``W_rec`` in float32 or bfloat16, ``n_steps <= MAX_STEPS`` and either
    the tensor-core bodies' limits (:func:`scan_bodies`) or the per-unit
    bodies' (``hidden <= 1024``, one thread per unit, ``W_rec`` within a
    block's shared memory); with ``training`` the backward's too."""
    device = torch.device(device)
    if n_steps < 1 or hidden < 1:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    if _plan(device, hidden, recurrent, itemsize == 2) is None:
        return False
    return not training or _plan_bwd(device, 1, hidden, n_steps, recurrent,
                                     itemsize == 2) is not None


def _check_scan(k, currents, w_rec):
    dev = currents.device
    T, B, H = currents.shape
    _f._check(k, "currents", currents, torch.float32, (T, B, H), dev)
    if w_rec is not None:
        _f._check_weights(k, w_rec)
        _f._check(k, "w_rec", w_rec, w_rec.dtype, (H, H), dev)
    if not 1 <= T <= MAX_STEPS:
        raise ValueError(f"{k}: n_steps must be in [1, {MAX_STEPS}], got {T}")
    return T, B, H


def _scan_cuda(currents, w_rec, kernel_params, train):
    """Launch ``izh_scan_fwd``; returns as :func:`_scan_reference`."""
    k = KERNEL_IZH_SCAN
    dev = currents.device
    T, B, H = _check_scan(k, currents, w_rec)
    bf16 = w_rec is not None and w_rec.dtype == torch.bfloat16
    plan = _plan(dev, H, w_rec is not None, bf16)
    if plan is None:
        raise ValueError(f"{k}: shape H={H} does not fit the kernel (gate on "
                         "izh_scan_supported)")
    z = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    v = torch.empty_like(z) if train else None
    lib = _lib()
    rc = lib.snn_izh_scan_fwd(
        currents.data_ptr(), _f._ptr(w_rec), z.data_ptr(), _f._ptr(v), B, H,
        T, int(bf16), *_consts(kernel_params), plan[0], int(plan[2]),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return z, v


def _scan_bwd_cuda(g_z, z, v, w_rec, kernel_params, gamma, spike_func,
                   keep=None):
    """Launch ``izh_scan_bwd`` (the chain and, with ``W_rec``, its gradient
    over spike bits) and add the blocks' slabs in a fixed order.  A dict
    ``keep`` receives ``g_W_rec``'s operand as ``dcur`` (B, T, H), a view
    of the float32 ``g_i``, which ``gbits_mma`` rounds as it reads; the z
    bits (``zmask``) and the float32 sum of ``g_W_rec`` (for tests)."""
    k = KERNEL_IZH_SCAN_BWD
    dev = v.device
    T, B, H = v.shape
    for name, t in (("g_z", g_z), ("z", z), ("v", v)):
        _f._check(k, name, t, torch.float32, (T, B, H), dev)
    if w_rec is not None:
        _f._check_weights(k, w_rec)
        _f._check(k, "w_rec", w_rec, w_rec.dtype, (H, H), dev)
    rec = w_rec is not None
    bf16 = rec and w_rec.dtype == torch.bfloat16
    n_rec = _plan_bwd(dev, B, H, T, rec, bf16)
    if n_rec is None:
        raise ValueError(f"{k}: shape T={T} H={H} does not fit the kernel "
                         "(gate on izh_scan_supported(training=True))")
    g_i = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    zmask = slab = None
    if rec:
        zmask = torch.empty((B, T + 1, (H + 31) // 32), dtype=torch.int32,
                            device=dev)
        slab = torch.empty((n_rec, H * H), dtype=torch.float32, device=dev)
    lib = _lib()
    p = _f._ptr
    rc = lib.snn_izh_scan_bwd(
        g_z.data_ptr(), z.data_ptr(), v.data_ptr(), p(w_rec), g_i.data_ptr(),
        p(zmask), p(slab), B, H, T,
        int(spike_func == SpikeFuncType.Phi), int(bf16),
        *_bwd_consts(kernel_params), float(gamma), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    _f._launched_function(_f.KERNEL_GBITS, int(rec))
    rec_sum = _f.gbits_sums(slab, None).view(H, H) if rec else None
    if keep is not None:
        keep.update(dcur=g_i.transpose(0, 1), zmask=zmask, g_w_rec=rec_sum)
    return g_i, None if not rec else rec_sum.to(w_rec.dtype)


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _ScanFn(torch.autograd.Function):
    """The scan with its backward: the forward keeps ``z`` and ``v``."""

    @staticmethod
    def forward(ctx, currents, w_rec, kernel_params, gamma, spike_func,
                plain):
        impl = _f._impl(currents, plain)
        fwd = _scan_cuda if impl == "cuda" else _scan_reference
        z, v = fwd(currents, w_rec, kernel_params, True)
        ctx.impl = impl
        ctx.statics = (kernel_params, gamma, spike_func)
        ctx.save_for_backward(w_rec, z, v)
        return z

    @staticmethod
    def backward(ctx, g_z):
        w_rec, z, v = ctx.saved_tensors
        bwd = _scan_bwd_cuda if ctx.impl == "cuda" else _scan_bwd_reference
        g_i, g_w_rec = bwd(g_z.to(torch.float32).contiguous(), z, v, w_rec,
                           *ctx.statics)
        return g_i, g_w_rec, None, None, None, None


def _scan(currents, w_rec, kernel_params, gamma, spike_func, plain=False):
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    currents = currents.to(torch.float32).contiguous()
    kernel_params = tuple(kernel_params)
    if _f._wants_grad(currents, w_rec):
        return _ScanFn.apply(currents, w_rec, kernel_params, float(gamma),
                             spike_func, plain)
    fwd = (_scan_cuda if _f._impl(currents, plain) == "cuda"
           else _scan_reference)
    return fwd(currents, w_rec, kernel_params, False)[0]


def izh_scan(
    currents: torch.Tensor,
    w_rec: Optional[torch.Tensor],
    kernel_params: tuple,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Izhikevich recurrence: currents ``(T, B, H)`` float32 [, masked
    ``W_rec`` (H, H) float32 or bfloat16, or None] -> spikes ``(T, B, H)``
    float32, differentiable in the currents and ``W_rec``.
    ``kernel_params`` is :func:`izh_kernel_params` of the layer's config."""
    return _scan(currents, w_rec, kernel_params, gamma, spike_func)


def izh_scan_reference(currents, w_rec, kernel_params, gamma,
                       spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid
                       ) -> torch.Tensor:
    """:func:`izh_scan` through the plain PyTorch versions, forward and
    backward, on whatever device the tensors lie."""
    return _scan(currents, w_rec, kernel_params, gamma, spike_func,
                 plain=True)
