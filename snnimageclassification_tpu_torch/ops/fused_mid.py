"""Hidden layers past the first: input product + LIF/ALIF scan in one call,
and the last hidden layer with the readout and the max over time.

Port of the JAX package's ops/pallas_fused_mid.py.  A hidden layer past
layer 0 consumes the previous layer's spike trace ``z_in (T, B, Hin)``:

* ``fused_mid_{rec,ff}_scan`` return this layer's spikes ``z (T, B, H)`` in
  the weights' dtype; the backward returns the cotangent of ``z_in`` for
  the layer before, ``g_W_in`` and ``g_W_rec``.
* ``fused_mid_{rec,ff}_scan_head`` run the last hidden layer, the readout
  ``v = kappa v + z @ W_out + b`` and the running max with strict ``>``
  (the first maximal step wins), and return the logits ``(B, O)``; the
  ``_counts`` variants also return the spike counts ``(B, H)``.

A network of N hidden layers is then layer 0 (``ops/fused.py``:
``fused_encode_{rec,ff}_scan``) -> N - 2 mid calls -> one mid-head call,
and neither a currents tensor, nor the readout trace, nor the last layer's
spike-trace cotangent exists in device memory.

Two hand-written CUDA kernels stand behind the wrappers:

* ``fused_mid_fwd`` (``csrc/fused_mid.cu``): both modes, inference and
  training.  The z-emitting mode writes ``z`` and, for training, the
  residuals of the JAX kernel (``delta`` for ALIF with FastSigmoid, ``v``
  for LIF, ``v`` and ``a`` for ALIF with Phi); the head mode writes the
  logits and, for training, ``delta`` (and ``a`` for ALIF with Phi),
  ``tstar`` and on request the counts.  Inference and training logits are
  bitwise equal.  Two bodies, chosen by shape (:func:`mid_bodies`): the
  tensor-core body (the input, recurrent and readout products as k16
  slices on bf16 tensor cores, the input product off the serial chain;
  its bits are those of ``_mid_fwd_ordered_reference``) and, past its
  limits, the per-unit body (sums as walks over spike bits).
* ``fused_mid_bwd`` (``csrc/fused_mid_bwd.cu``): the reverse chain (the
  tensor-core chain body of ``csrc/chain_mma.cuh`` in both modes where
  :func:`mid_bodies` says ``"mma"``, else the per-unit chain), ``g_z_in =
  dcur @ W_in^T`` as a tensor-core product of its own
  (``csrc/gzin_mma.cuh``), and the weight gradients (``gbits_mma``,
  ``bwd_gout``).
  ``_mid_bwd_ordered_reference`` is its plain version in its summation
  order.

On a CUDA tensor a wrapper launches the kernels or raises; on the CPU it
runs the plain PyTorch versions (``_mid_reference``,
``_mid_bwd_reference``), which the tests hold against the JAX kernels.  The
``*_reference`` entry points run the plain versions on any device.

Operand and rounding rules are those of ``ops/fused.py``: products take the
weights' dtype, sums are float32, ``s`` and ``dcur`` are rounded to the
weights' dtype before each product, ``z`` and ``g_z_in`` carry the dtype of
the weights and of ``z_in``; ``beta`` gets a zero cotangent.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused as _f
from .fused import KERNEL_MID, KERNEL_MID_BWD, MAX_STEPS, Beta
from .surrogate import SpikeFuncType

__all__ = [
    "fused_mid_rec_scan",
    "fused_mid_ff_scan",
    "fused_mid_rec_scan_head",
    "fused_mid_ff_scan_head",
    "fused_mid_rec_scan_head_counts",
    "fused_mid_ff_scan_head_counts",
    "fused_mid_rec_scan_reference",
    "fused_mid_ff_scan_reference",
    "fused_mid_rec_scan_head_reference",
    "fused_mid_ff_scan_head_reference",
    "fused_mid_rec_scan_head_counts_reference",
    "fused_mid_ff_scan_head_counts_reference",
    "fused_mid_supported",
    "fused_mid_head_supported",
    "mid_bodies",
]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------
def _mid_reference(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif,
                   alpha, rho, threshold, kappa, train, store_a,
                   want_counts, res_is_v):
    """Plain version of ``fused_mid_fwd``: ``(logits, z, res, a, tstar,
    counts)`` as :func:`ops.fused._scan_loop`; a head where ``w_out`` is
    given.  The input current of a step is the sum of the rows of ``W_in``
    that ``z_in(t)`` selects.  ``train`` keeps the residuals and
    ``tstar``; the counts come on request in either mode."""
    f32 = torch.float32
    w_in32 = w_in.to(f32)
    return _f._scan_loop(
        lambda t: z_in[t].to(f32) @ w_in32, z_in.shape[1], w_in.shape[1],
        z_in.device, w_in.dtype, w_rec, beta, w_out, b_out, n_steps, alif,
        alpha, rho, threshold, kappa, train, train, store_a, want_counts,
        res_is_v)


def _mid_fwd_ordered_reference(z_in, w_in, w_rec, beta, w_out, b_out,
                               n_steps, alif, alpha, rho, threshold, kappa,
                               train, store_a, want_counts, res_is_v):
    """Plain version of ``fused_mid_fwd``'s tensor-core body
    (``csrc/fused_mid.cu:mid_mma_kernel``) in its summation order; returns
    as :func:`_mid_reference`.  Every product is k16-sliced as the tensor
    cores form it (``ops/fused.py:_slice_product``: float32 weights as
    three bf16 pieces, each slice's product added in float32 in ascending
    k): the input current ``z_in(t) @ W_in``, then, past step 0, the
    recurrent current ``z(t-1) @ W_rec`` added to it, and the readout
    ``v_r = kappa v_r + (z(t) @ W_out + b)``.  The cell step is the plain
    loop's (``fused._Cell``)."""
    f32 = torch.float32
    wd = w_in.dtype
    T, B, _ = z_in.shape
    H = w_in.shape[1]
    dev = z_in.device
    pieces = _f._weight_pieces
    in_p = pieces(w_in)
    rec_p = None if w_rec is None else pieces(w_rec)
    cell = _f._Cell(B, H, dev, None, beta, alif, want_counts)
    readout = (None if w_out is None
               else _f._Readout(B, w_out, b_out, kappa, dev, sliced=True))
    zs, res, a_trace = [], [], []
    for t in range(n_steps):
        cur = _f._slice_product(z_in[t].to(f32), in_p)
        if rec_p is not None and t > 0:
            cur = cur + _f._slice_product(cell.z, rec_p)
        delta = cell.step(cur, alpha, rho, threshold)
        if readout is not None:
            readout.step(cell.z, t, train)
        else:
            zs.append(cell.z.to(wd))
        if train:
            res.append((cell.v if res_is_v else delta).to(wd))
            if store_a:
                a_trace.append(cell.a.to(wd))
    stack = _f._stack
    if readout is None:
        return None, stack(zs), stack(res), stack(a_trace), None, \
            cell.counts
    return (readout.m, None, stack(res), stack(a_trace), readout.tstar,
            cell.counts)


def _mid_bwd_reference(g_logits, g_counts, tstar, g_z, z, res, a_tr,
                       res_is_v, z_in, w_in, w_rec, beta, w_out, n_steps,
                       alpha, threshold, gamma, kappa, spike_func):
    """Plain version of ``fused_mid_bwd``: ``(g_z_in (T, B, Hin) in the
    dtype of z_in, g_w_in, g_w_rec | None, g_w_out | None, g_b | None)``,
    the weights' gradients in the weights' dtype."""
    f32 = torch.float32
    g_z_in, g_w_in, g_w_rec, g_w_out, g_b = _f._bwd_loop(
        lambda t: z_in[t].to(f32), w_in.to(f32).T, g_logits, g_counts,
        tstar, g_z, res, a_tr, z, res_is_v, w_rec, beta, w_out, n_steps,
        alpha, threshold, gamma, kappa, spike_func, w_in.dtype)
    return (g_z_in.to(z_in.dtype), g_w_in.to(w_in.dtype),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype),
            None if g_w_out is None else g_w_out.to(w_out.dtype), g_b)


def _step_rows(x: torch.Tensor) -> torch.Tensor:
    """A ``(T, B, J)`` 0/1 trace as ``gbits_mma``'s left operand: ``(B T,
    J)`` float32 with row ``b T + t`` holding ``x(t)`` of row ``b``."""
    return x.to(torch.float32).transpose(0, 1).reshape(-1, x.shape[2])


def _mid_bwd_ordered_reference(g_logits, g_counts, tstar, g_z, z, res, a_tr,
                               res_is_v, z_in, w_in, w_rec, beta, w_out,
                               n_steps, alpha, threshold, gamma, kappa,
                               spike_func, order, card=False, keep=None):
    """Plain version of ``fused_mid_bwd`` in its summation order; returns as
    :func:`_mid_bwd_reference`.  The chain with the tensor-core chain
    body's products (``fused._split_slice_product``: ``s @ W_out^T`` in
    head mode, ``dcur(t+1) @ W_rec^T``), then from the chain's rounded
    ``dcur``: ``g_z_in`` through ``fused._gzin_ordered_reference``
    (``card``: the card's accumulation model), rounded once to the type of
    ``z_in``; ``g_W_in`` (left operand ``z_in(t)``) and ``g_W_rec`` (``z(t -
    1)``) through ``gbits._gbits_ordered_reference``; ``g_W_out`` and
    ``g_b`` through ``fused._gout_ordered_reference``.  ``order`` is the
    kernel's plan (:func:`gradient_plan`).  A dict ``keep`` receives the
    chain's rounded ``dcur (B, T, H)`` float32."""
    from .gbits import _gbits_ordered_reference

    f32 = torch.float32
    wd = w_in.dtype
    T, B, _ = z_in.shape
    H = w_in.shape[1]
    head = w_out is not None
    dcur = torch.zeros((B, n_steps, H), dtype=f32, device=z_in.device)
    _f._bwd_loop(
        lambda t: z_in[t].to(f32), None, g_logits, g_counts, tstar, g_z, res,
        a_tr, z, res_is_v, w_rec, beta, w_out, n_steps, alpha, threshold,
        gamma, kappa, spike_func, wd, dcur_out=dcur,
        matmul=lambda a, w: _f._split_slice_product(a, w.contiguous(), wd))
    if keep is not None:
        keep["dcur"] = dcur
    g_z_in = _f._gzin_ordered_reference(dcur, w_in, wd, card).to(z_in.dtype)
    d = dcur.view(B * n_steps, H)
    g_w_in = _gbits_ordered_reference(d, _step_rows(z_in), B, n_steps,
                                      order["groups_in"], wd)
    g_w_rec = None
    if w_rec is not None:
        z_prev = (_f.z_prev_rows(res) if head else _step_rows(torch.cat(
            [torch.zeros_like(z[:1]), z[:-1]])))
        g_w_rec = _gbits_ordered_reference(d, z_prev, B, n_steps,
                                           order["groups_rec"], wd)
    g_w_out = g_b = None
    if head:
        g_w_out, g_b = _f._gout_ordered_reference(
            (res >= 0).to(f32), g_logits, tstar, kappa, wd,
            order["groups_out"], order["rows_out"])
        g_w_out = g_w_out.to(w_out.dtype)
    return (g_z_in, g_w_in.to(wd),
            None if g_w_rec is None else g_w_rec.to(w_rec.dtype), g_w_out,
            g_b)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL, name: str) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    if name == "fused_mid":
        lib.snn_fused_mid_plan.argtypes = [i] * 6 + [ip, ip]
        lib.snn_fused_mid_plan.restype = i
        lib.snn_fused_mid_fwd.argtypes = (
            [vp] * 12 + [i] * 8 + [f] * 4 + [i, vp, i, vp])
        lib.snn_fused_mid_fwd.restype = i
        lib.snn_fused_mid_body.argtypes = [i] * 6 + [ip]
        lib.snn_fused_mid_body.restype = i
    else:
        lib.snn_fused_mid_bwd_plan.argtypes = [i] * 8 + [ip]
        lib.snn_fused_mid_bwd_plan.restype = i
        lib.snn_fused_mid_bwd.argtypes = (
            [vp] * 19 + [i] * 8 + [f] * 4 + [i, vp])
        lib.snn_fused_mid_bwd.restype = i
        lib.snn_gzin.argtypes = [vp] * 3 + [i] * 7 + [vp]
        lib.snn_gzin.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib(name: str = "fused_mid") -> ctypes.CDLL:
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_snn_declared", False):
        _declare(lib, name)
    return lib


def _plan(device: torch.device, Hin: int, H: int, O: int, recurrent: bool,
          bf16: bool) -> Optional[Tuple[int, int]]:
    """(rows per block, shared-memory bytes) of ``fused_mid_fwd`` on
    ``device`` (``O == 0``: the z-emitting mode), or None when the shape
    does not fit."""
    lib = _lib()
    rows, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.snn_fused_mid_plan(Hin, H, O, int(recurrent), int(bf16),
                                _f._index(device), ctypes.byref(rows),
                                ctypes.byref(smem))
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_MID} plan")
    return rows.value, smem.value


def _body(device: torch.device, Hin: int, H: int, O: int, recurrent: bool,
          bf16: bool) -> Tuple[bool, int]:
    """``fused_mid_fwd``'s body for a shape it takes: (the tensor-core body,
    bytes of scratch a launch needs: W_in's fragments where its bf16 pieces
    do not fit shared memory and come from L2)."""
    lib = _lib()
    out = (ctypes.c_int * 2)()
    rc = lib.snn_fused_mid_body(Hin, H, O, int(recurrent), int(bf16),
                                _f._index(device), out)
    _f._raise_on(rc, lib, f"{KERNEL_MID} body")
    return bool(out[0]), out[1]


def _plan_bwd_words(device: torch.device, B: int, Hin: int, H: int, O: int,
                    T: int, recurrent: bool,
                    bf16: bool) -> Optional[Tuple[int, ...]]:
    """``snn_fused_mid_bwd_plan``'s five words on ``device``, or None when
    the shape does not fit."""
    lib = _lib("fused_mid_bwd")
    out = (ctypes.c_int * 5)()
    rc = lib.snn_fused_mid_bwd_plan(B, Hin, H, O, T, int(recurrent),
                                    int(bf16), _f._index(device), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_MID_BWD} plan")
    return tuple(out)


def _plan_bwd(device: torch.device, B: int, Hin: int, H: int, O: int, T: int,
              recurrent: bool, bf16: bool) -> Optional[Tuple[int, int, int]]:
    """Blocks of (g_W_in, g_W_rec, g_W_out/g_b) partial slabs of
    ``fused_mid_bwd`` on ``device``, or None when the shape does not fit."""
    out = _plan_bwd_words(device, B, Hin, H, O, T, recurrent, bf16)
    return None if out is None else out[:3]


def gradient_plan(device, B: int, Hin: int, H: int, O: int, T: int,
                  recurrent: bool, bf16: bool) -> dict:
    """The order of ``fused_mid_bwd`` on ``device`` for a shape (``O ==
    0``: the z-emitting mode): ``groups_in`` / ``groups_rec`` /
    ``groups_out`` blocks (slabs) of ``gbits_mma`` (``g_W_in``, ``g_W_rec``)
    and ``bwd_gout``, ``rows_out`` rows a batch of ``bwd_gout``, and
    ``mma``, whether the chain takes its tensor-core body.
    :func:`_mid_bwd_ordered_reference` takes it."""
    out = _plan_bwd_words(torch.device(device), B, Hin, H, O, T, recurrent,
                          bf16)
    if out is None:
        raise ValueError(f"{KERNEL_MID_BWD}: shape T={T} Hin={Hin} H={H} "
                         f"O={O} does not fit the kernel")
    return {"groups_in": out[0], "groups_rec": out[1], "groups_out": out[2],
            "mma": bool(out[3]), "rows_out": out[4]}


def _supported(n_steps, hidden_in, hidden, n_out, recurrent, itemsize,
               device, training) -> bool:
    device = torch.device(device)
    if n_steps < 1 or hidden_in < 1 or hidden < 1 or n_out < 0:
        return False
    if device.type == "cpu":
        return True
    if device.type != "cuda" or itemsize not in (2, 4) \
            or n_steps > MAX_STEPS:
        return False
    if _plan(device, hidden_in, hidden, n_out, recurrent,
             itemsize == 2) is None:
        return False
    return not training or _plan_bwd(
        device, 1, hidden_in, hidden, n_out, n_steps, recurrent,
        itemsize == 2) is not None


def fused_mid_supported(n_steps: int, hidden_in: int, hidden: int,
                        recurrent: bool = True, itemsize: int = 4,
                        device="cuda", training: bool = False) -> bool:
    """Whether the z-emitting mid layer covers this shape on ``device``.

    On the CPU the plain versions cover every shape.  On a CUDA device the
    kernel needs float32 or bfloat16 weights, ``hidden <= 1024`` (one
    thread per unit), ``hidden_in`` at most four times ``hidden`` (both
    rounded up to 32: a thread stages at most four input spikes a step),
    and ``W_in`` (and ``W_rec``) within the block's shared memory; with
    ``training`` the backward kernel must fit too (one row's ``(n_steps,
    hidden)`` float32 table in shared memory)."""
    return _supported(n_steps, hidden_in, hidden, 0, recurrent, itemsize,
                      device, training)


def fused_mid_head_supported(n_steps: int, hidden_in: int, hidden: int,
                             n_out: int, recurrent: bool = True,
                             itemsize: int = 4, device="cuda",
                             training: bool = False) -> bool:
    """:func:`fused_mid_supported` for the head mode, which also keeps
    ``W_out`` and the readout state in shared memory."""
    if n_out < 1:
        return False
    return _supported(n_steps, hidden_in, hidden, n_out, recurrent, itemsize,
                      device, training)


def mid_bodies(n_steps: int, hidden_in: int, hidden: int, n_out: int = 0,
               recurrent: bool = True, itemsize: int = 4, device="cuda",
               training: bool = False) -> Tuple[str, ...]:
    """The body each mid-layer kernel runs a shape on (``n_out == 0``: the
    z-emitting mode), for a shape :func:`fused_mid_supported` /
    :func:`fused_mid_head_supported` takes on a CUDA device: ``"mma"``
    (the tensor-core body: a warp owns 16 rows x 32 units, the input,
    recurrent and readout products on bf16 tensor cores, the input product
    off the serial chain) or ``"per-unit"`` (one thread a (row, unit), the
    sums as walks over spike bits; O > 16, H > 256, ``hidden_in`` past
    about 1.5 ``hidden`` (the input values a thread stages a step), or the
    weights' bf16 pieces past a block's shared memory).  One entry for the
    forward, a second for the backward's chain (``fused_mid_bwd``: the
    tensor-core chain body, ``"mma"``, where O <= 16, H <= 256 and the
    weights' bf16 pieces fit a block's shared memory, else the per-unit
    chain) with ``training``.  On the CPU the plain versions: ``"plain"``
    entries."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("plain",) * (1 + int(training))
    bf16 = itemsize == 2
    mma = _body(device, hidden_in, hidden, n_out, recurrent, bf16)[0]
    out = ("mma" if mma else "per-unit",)
    if training:
        words = _plan_bwd_words(device, 1, hidden_in, hidden, n_out, n_steps,
                                recurrent, bf16)
        out += ("mma" if words is not None and words[3] else "per-unit",)
    return out


def _check_inputs(k, z_in, w_in, w_rec, w_out, b_out, n_steps):
    """Validate the forward's inputs; returns (B, Hin, H, O, rows)."""
    dev = z_in.device
    _f._check_weights(k, w_in)
    wdt = w_in.dtype
    T, B, Hin = z_in.shape
    H = w_in.shape[1]
    O = 0 if w_out is None else w_out.shape[1]
    if T != n_steps or not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(f"{k}: z_in has {T} steps, n_steps={n_steps} "
                         f"(at most {MAX_STEPS})")
    _f._check(k, "z_in", z_in, wdt, (T, B, Hin), dev)
    _f._check(k, "w_in", w_in, wdt, (Hin, H), dev)
    if w_rec is not None:
        _f._check(k, "w_rec", w_rec, wdt, (H, H), dev)
    if w_out is not None:
        _f._check(k, "w_out", w_out, wdt, (H, O), dev)
        _f._check(k, "b_out", b_out, torch.float32, (O,), dev)
    plan = _plan(dev, Hin, H, O, w_rec is not None, wdt == torch.bfloat16)
    if plan is None:
        raise ValueError(
            f"{k}: shape Hin={Hin} H={H} O={O} does not fit the kernel "
            "(gate on fused_mid_supported / fused_mid_head_supported)")
    return B, Hin, H, O, plan[0]


def _mid_cuda(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha,
              rho, threshold, kappa, train, store_a, want_counts, res_is_v):
    """Launch ``fused_mid_fwd``; returns as :func:`_mid_reference`."""
    k = KERNEL_MID
    dev = z_in.device
    B, Hin, H, O, rows = _check_inputs(k, z_in, w_in, w_rec, w_out, b_out,
                                       n_steps)
    head = w_out is not None
    trace = dict(dtype=w_in.dtype, device=dev)
    shape = (n_steps, B, H)
    z = None if head else torch.empty(shape, **trace)
    res = torch.empty(shape, **trace) if train else None
    a_tr = torch.empty(shape, **trace) if train and store_a else None
    logits = tstar = counts = None
    if head:
        logits = torch.empty((B, O), dtype=torch.float32, device=dev)
        if train:
            tstar = torch.empty((B, O), dtype=torch.int32, device=dev)
        if want_counts:
            counts = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _lib()
    p = _f._ptr
    bf16 = w_in.dtype == torch.bfloat16
    _, nbytes = _body(dev, Hin, H, O, w_rec is not None, bf16)
    # W_in's fragments, where the tensor-core body reads them from L2.
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    beta_t = _f._beta_tensor(beta, dev)
    rc = lib.snn_fused_mid_fwd(
        z_in.data_ptr(), w_in.data_ptr(), p(w_rec), beta_t.data_ptr(),
        p(w_out), p(b_out), p(z), p(res), p(a_tr), p(logits), p(tstar),
        p(counts), B, Hin, H, O, n_steps, int(alif), int(bf16),
        int(res_is_v), alpha, rho, threshold, kappa, rows, p(scratch),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    return logits, z, res, a_tr, tstar, counts


def _mid_bwd_cuda(g_logits, g_counts, tstar, g_z, z, res, a_tr, res_is_v,
                  z_in, w_in, w_rec, beta, w_out, n_steps, alpha, threshold,
                  gamma, kappa, spike_func, keep=None):
    """Launch ``fused_mid_bwd`` (its ``__global__`` functions in one call)
    and add the blocks' partial slabs in a fixed order.  A dict ``keep``
    receives the chain's rounded ``dcur``, the bits of ``z`` and ``z_in``
    (``zmask``, ``zinmask``) and the float32 sums of ``g_W_in`` and
    ``g_W_rec`` (``gbits_mma``'s) before their cast (for tests)."""
    k = KERNEL_MID_BWD
    dev = z_in.device
    T, B, Hin = z_in.shape
    H = w_in.shape[1]
    head = w_out is not None
    O = w_out.shape[1] if head else 0
    wdt = w_in.dtype
    _f._check_weights(k, w_in)
    _f._check(k, "z_in", z_in, wdt, (T, B, Hin), dev)
    _f._check(k, "w_in", w_in, wdt, (Hin, H), dev)
    _f._check(k, "res", res, wdt, (T, B, H), dev)
    if a_tr is not None:
        _f._check(k, "a", a_tr, wdt, (T, B, H), dev)
    if w_rec is not None:
        _f._check(k, "w_rec", w_rec, wdt, (H, H), dev)
    if head:
        _f._check(k, "w_out", w_out, wdt, (H, O), dev)
        _f._check(k, "g_logits", g_logits, torch.float32, (B, O), dev)
        _f._check(k, "tstar", tstar, torch.int32, (B, O), dev)
        if g_counts is not None:
            _f._check(k, "g_counts", g_counts, torch.float32, (B, H), dev)
    else:
        _f._check(k, "g_z", g_z, wdt, (T, B, H), dev)
        _f._check(k, "z", z, wdt, (T, B, H), dev)
    bf16 = wdt == torch.bfloat16
    plan = _plan_bwd_words(dev, B, Hin, H, O, T, w_rec is not None, bf16)
    if plan is None:
        raise ValueError(
            f"{k}: shape T={T} Hin={Hin} H={H} O={O} does not fit the "
            "kernel (gate on fused_mid[_head]_supported(training=True))")
    n_in, n_rec, n_out = plan[:3]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    # Scratch of the call: dcur(t) per row, the bits of z and of z_in.
    dcur = torch.empty((B, T, H), dtype=wdt, device=dev)
    zmask = torch.empty((B, T + 1, (H + 31) // 32), **i32)
    zinmask = torch.empty((B, T, (Hin + 31) // 32), **i32)
    g_z_in = torch.empty((T, B, Hin), dtype=wdt, device=dev)
    slab_in = torch.empty((n_in, Hin * H), **f32)
    slab_rec = torch.empty((n_rec, H * H), **f32)
    slab_out = torch.empty((n_out, H * O + O), **f32)
    lib = _lib("fused_mid_bwd")
    p = _f._ptr
    rc = lib.snn_fused_mid_bwd(
        p(g_logits), p(tstar), p(g_counts), p(g_z), p(z), res.data_ptr(),
        p(a_tr), z_in.data_ptr(), w_in.data_ptr(), p(w_rec), p(w_out),
        _f._beta_tensor(beta, dev).data_ptr(), dcur.data_ptr(),
        zmask.data_ptr(), zinmask.data_ptr(), g_z_in.data_ptr(),
        slab_in.data_ptr(), slab_rec.data_ptr(), slab_out.data_ptr(), B, Hin,
        H, O, T, int(spike_func == SpikeFuncType.Phi), int(bf16),
        int(res_is_v), alpha, threshold, gamma, kappa, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched(k)
    _f._launched_function(_f.KERNEL_GBITS, 1 + int(w_rec is not None))
    _f._launched_function(_f.KERNEL_GZIN)
    in_sum = _f.gbits_sums(slab_in, None).view(Hin, H)
    rec_sum = (None if w_rec is None
               else _f.gbits_sums(slab_rec, None).view(H, H))
    if keep is not None:
        keep.update(dcur=dcur, zmask=zmask, zinmask=zinmask, g_w_in=in_sum,
                    g_w_rec=rec_sum)
    g_w_in = in_sum.to(wdt)
    g_w_rec = None if rec_sum is None else rec_sum.to(wdt)
    if not head:
        return g_z_in, g_w_in, g_w_rec, None, None
    out_sum = slab_out.sum(0)
    return (g_z_in, g_w_in, g_w_rec, out_sum[:H * O].view(H, O).to(wdt),
            out_sum[H * O:].clone())


def _gzin_reference(dcur: torch.Tensor, w: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``gzin_mma``: ``(dcur @ w^T)`` in float32, ``(T, B,
    N)``, rounded once to ``out_dtype``."""
    f32 = torch.float32
    return (dcur.to(f32) @ w.to(f32).T).transpose(0, 1).to(out_dtype)


def gzin(dcur: torch.Tensor, w: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``g_z_in (T, B, N) = dcur @ w^T`` from the chain's rounded ``dcur (B,
    T, K)`` and ``w (N, K)`` (a mid layer's ``W_in``, the two-layer pair's
    ``W1``), both in the weights' dtype, rounded once to ``out_dtype`` (the
    weights' dtype, or float32).  On a CUDA tensor ``gzin_mma``
    (``csrc/gzin_mma.cuh``, the product ``fused_mid_bwd`` and ``fused2_bwd``
    launch inside their calls), else the plain version."""
    k = _f.KERNEL_GZIN
    wd = w.dtype
    out_dtype = out_dtype or wd
    B, T, K = dcur.shape
    N = w.shape[0]
    if out_dtype not in (wd, torch.float32):
        raise ValueError(f"{k}: out_dtype must be {wd} or float32")
    if dcur.device.type != "cuda":
        return _gzin_reference(dcur, w, out_dtype)
    _f._check_weights(k, w)
    _f._check(k, "dcur", dcur, wd, (B, T, K), dcur.device)
    _f._check(k, "w", w, wd, (N, K), dcur.device)
    dev = dcur.device
    out = torch.empty((T, B, N), dtype=out_dtype, device=dev)
    lib = _lib("fused_mid_bwd")
    rc = lib.snn_gzin(dcur.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, K,
                      N, int(wd == torch.bfloat16),
                      int(out_dtype == torch.float32 and wd != torch.float32),
                      dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _f._raise_on(rc, lib, f"{k} launch")
    _f._launched_function(k)
    return out


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------
class _MidFn(torch.autograd.Function):
    """A mid layer (z-emitting or head) with its backward.  Outputs: ``z``,
    or ``logits``, or ``(logits, counts)``."""

    @staticmethod
    def forward(ctx, z_in, w_in, w_rec, beta, w_out, b_out, statics,
                want_counts, plain):
        (n_steps, alif, alpha, rho, threshold, gamma, kappa,
         spike_func) = statics
        head = w_out is not None
        impl = _f._impl(z_in, plain)
        fwd = _mid_cuda if impl == "cuda" else _mid_reference
        res_is_v = not head and _f._residual_is_v(alif, spike_func)
        logits, z, res, a_tr, tstar, counts = fwd(
            z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha, rho,
            threshold, kappa, True, _f._stores_a(alif, spike_func),
            want_counts, res_is_v)
        ctx.impl, ctx.statics, ctx.beta, ctx.res_is_v = (impl, statics, beta,
                                                         res_is_v)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(z_in, w_in, w_rec, w_out, z, res, a_tr, tstar)
        if not head:
            return z
        return (logits, counts) if want_counts else logits

    @staticmethod
    def backward(ctx, g_out, g_counts=None):
        z_in, w_in, w_rec, w_out, z, res, a_tr, tstar = ctx.saved_tensors
        (n_steps, _, alpha, _, threshold, gamma, kappa,
         spike_func) = ctx.statics
        g_logits = g_z = None
        if w_out is None:
            g_z = (torch.zeros_like(z) if g_out is None
                   else g_out.to(z.dtype).contiguous())
        else:
            g_logits = (torch.zeros(tstar.shape, dtype=torch.float32,
                                    device=z_in.device) if g_out is None
                        else g_out.to(torch.float32).contiguous())
            if g_counts is not None:
                g_counts = g_counts.to(torch.float32).contiguous()
        bwd = _mid_bwd_cuda if ctx.impl == "cuda" else _mid_bwd_reference
        g_z_in, g_w_in, g_w_rec, g_w_out, g_b = bwd(
            g_logits, g_counts, tstar, g_z, z, res, a_tr, ctx.res_is_v, z_in,
            w_in, w_rec, ctx.beta, w_out, n_steps, alpha, threshold, gamma,
            kappa, spike_func)
        return (g_z_in, g_w_in, g_w_rec, _f._zero_beta_grad(ctx.beta),
                g_w_out, g_b, None, None, None)


def _mid(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha, rho,
         threshold, gamma, kappa, spike_func, want_counts, plain=False):
    scalars = (int(n_steps), bool(alif), float(alpha), float(rho),
               float(threshold))
    kappa = float(kappa)
    if isinstance(spike_func, str):
        spike_func = SpikeFuncType[spike_func]
    if z_in.dtype != w_in.dtype:
        z_in = z_in.to(w_in.dtype)  # 0/1: exact in either dtype
    z_in = z_in.contiguous()
    if _f._wants_grad(z_in, w_in, w_rec, beta, w_out, b_out):
        statics = (*scalars, float(gamma), kappa, spike_func)
        return _MidFn.apply(z_in, w_in, w_rec, beta, w_out, b_out, statics,
                            want_counts, plain)
    fwd = _mid_cuda if _f._impl(z_in, plain) == "cuda" else _mid_reference
    # Inference: no residual leaves the kernel.
    logits, z, _, _, _, counts = fwd(
        z_in, w_in, w_rec, beta, w_out, b_out, *scalars, kappa, False,
        False, want_counts, False)
    if w_out is None:
        return z
    return (logits, counts) if want_counts else logits


def fused_mid_rec_scan(
    z_in: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: torch.Tensor,
    beta: Beta,
    n_steps: int,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """(z_in (T, B, Hin) spike trace, W_in, masked W_rec) -> spikes ``(T,
    B, H)`` in the weights' dtype, differentiable in ``z_in`` and the
    weights.  For LIF pass ``alif=False`` (``beta``, ``rho`` ignored)."""
    return _mid(z_in, w_in, w_rec, beta, None, None, n_steps, alif, alpha,
                rho, threshold, gamma, 0.0, spike_func, False)


def fused_mid_ff_scan(
    z_in: torch.Tensor,
    w_in: torch.Tensor,
    beta: Beta,
    n_steps: int,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    gamma: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Feedforward mid-layer variant: no recurrent weights."""
    return _mid(z_in, w_in, None, beta, None, None, n_steps, alif, alpha,
                rho, threshold, gamma, 0.0, spike_func, False)


def fused_mid_rec_scan_head(
    z_in: torch.Tensor,
    w_in: torch.Tensor,
    w_rec: torch.Tensor,
    beta: Beta,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    n_steps: int,
    alif: bool,
    alpha: float,
    rho: float,
    threshold: float,
    gamma: float,
    kappa: float,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """(z_in (T, B, Hin) spike trace, weights) -> max-over-time logits
    ``(B, O)``; the backward also returns the cotangent of ``z_in``."""
    return _mid(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, False)


def fused_mid_ff_scan_head(
    z_in, w_in, beta, w_out, b_out, n_steps, alif, alpha, rho, threshold,
    gamma, kappa, spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Feedforward mid-head variant: no recurrent weights."""
    return _mid(z_in, w_in, None, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, False)


def fused_mid_rec_scan_head_counts(
    z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha, rho,
    threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`fused_mid_rec_scan_head` but returns ``(logits (B, O),
    spike_counts (B, H))``, differentiable in both."""
    return _mid(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, True)


def fused_mid_ff_scan_head_counts(
    z_in, w_in, beta, w_out, b_out, n_steps, alif, alpha, rho, threshold,
    gamma, kappa, spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feedforward mid-head + counts variant."""
    return _mid(z_in, w_in, None, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, True)


def fused_mid_rec_scan_reference(
    z_in, w_in, w_rec, beta, n_steps, alif, alpha, rho, threshold, gamma,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """:func:`fused_mid_rec_scan` through the plain PyTorch versions,
    forward and backward, on whatever device the tensors lie."""
    return _mid(z_in, w_in, w_rec, beta, None, None, n_steps, alif, alpha,
                rho, threshold, gamma, 0.0, spike_func, False, plain=True)


def fused_mid_ff_scan_reference(
    z_in, w_in, beta, n_steps, alif, alpha, rho, threshold, gamma,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mid_ff_scan`."""
    return _mid(z_in, w_in, None, beta, None, None, n_steps, alif, alpha,
                rho, threshold, gamma, 0.0, spike_func, False, plain=True)


def fused_mid_rec_scan_head_reference(
    z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha, rho,
    threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mid_rec_scan_head`."""
    return _mid(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, False, plain=True)


def fused_mid_ff_scan_head_reference(
    z_in, w_in, beta, w_out, b_out, n_steps, alif, alpha, rho, threshold,
    gamma, kappa, spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mid_ff_scan_head`."""
    return _mid(z_in, w_in, None, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, False, plain=True)


def fused_mid_rec_scan_head_counts_reference(
    z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha, rho,
    threshold, gamma, kappa,
    spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_mid_rec_scan_head_counts`."""
    return _mid(z_in, w_in, w_rec, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, True, plain=True)


def fused_mid_ff_scan_head_counts_reference(
    z_in, w_in, beta, w_out, b_out, n_steps, alif, alpha, rho, threshold,
    gamma, kappa, spike_func: SpikeFuncType = SpikeFuncType.FastSigmoid,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_mid_ff_scan_head_counts`."""
    return _mid(z_in, w_in, None, beta, w_out, b_out, n_steps, alif, alpha,
                rho, threshold, gamma, kappa, spike_func, True, plain=True)
