"""The bit-masked weight gradient ``sum_k bit(k)^T d(k)`` of every backward.

``csrc/gbits_mma.cuh`` computes each ``g_W_rec`` of the port (the head,
layer 0, the mid layer, the two-layer pair, the Izhikevich head, the
Izhikevich scan, the wide net's recurrent scan) and a mid layer's
``g_W_in`` as one tensor-core product: ``k`` runs over (batch row, step)
pairs, ``bit(k)`` is a 0/1 spike row given as 32-bit mask words and
``d(k)`` the chain's cotangent of the input current, rounded to the
weights' dtype.  Every backward launches it inside its own call; this
module holds

* the plan of a shape (:func:`plan`) and the call on its own
  (:func:`gbits`: the kernel on a CUDA tensor, the plain version on a CPU
  one), for tests, timing and the ordered plain version;
* the plain versions: order-free (:func:`_gbits_reference`), in the
  kernel's order (:func:`_gbits_ordered_reference`: the blocks' unit
  ranges, the k16 slices, the bf16 pieces, each slice's product exact and
  rounded to nearest), the exact float64 sum (:func:`exact_sum`) and the
  parent's bit walk (:func:`_gbits_walk_reference`, the order of the CUDA-core
  sums it replaced, for the error bar of the tests);
* CPU twins of the kernel's fragments: the A fragment built from mask
  words (:func:`a_fragment`), the B fragment of ``d``'s pieces
  (:func:`b_fragment`) and the product mma.m16n8k16 takes from them
  (:func:`fragment_product`).

``k`` runs over (batch row ``b``, step ``t``); ``d`` and ``left`` are ``(B
T, ·)`` views in their memory order: the fused callers' ``dcur (B, T, H)``
(row ``b T + t``; the mask words ``nrows`` rows a batch row, the head's
``zmask`` ``T + 1`` with row ``t`` holding ``z(t - 1)``), or with
``step_major`` the wide net's ``g_i (T, B, H)`` (row ``t B + b``, its mask
words ``(T, B, BW)`` likewise).  Block ``y`` of ``groups`` sums the batch
rows ``[y B / groups, (y + 1) B / groups)`` in k16 slices of 16 rows at one
step: the steps in ascending order, within a step the chunks of 16 rows.
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import torch

from . import fused as _f
from .head_mma import split_pieces

__all__ = [
    "KERNEL_GBITS",
    "pack_bits",
    "unpack_bits",
    "plan",
    "gbits",
    "exact_sum",
    "walk_groups",
    "a_fragment",
    "b_fragment",
    "fragment_product",
]

KERNEL_GBITS = _f.KERNEL_GBITS
SLICE = 16  # k rows a tensor-core slice (mma.m16n8k16)


# ---------------------------------------------------------------------------
# Mask words
# ---------------------------------------------------------------------------
def pack_bits(left: torch.Tensor) -> torch.Tensor:
    """``left (..., J)`` 0/1 -> ``(..., ceil(J / 32))`` int32 mask words,
    bit ``j % 32`` of word ``j // 32`` set where ``left[..., j]`` is
    nonzero (as the chains write ``zmask``)."""
    J = left.shape[-1]
    BW = (J + 31) // 32
    on = torch.zeros(left.shape[:-1] + (BW * 32,), dtype=torch.int64,
                     device=left.device)
    on[..., :J] = (left != 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=left.device)
    words = (on.view(*left.shape[:-1], BW, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(words: torch.Tensor, J: int) -> torch.Tensor:
    """Mask words ``(..., BW)`` -> ``(..., J)`` float32 0/1."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :J].to(torch.float32)


def _rows_of(words: torch.Tensor, B: int, T: int,
             nrows: int) -> torch.Tensor:
    """The mask rows of the ``B T`` rows ``b T + t``: ``words`` holds ``B``
    units of ``nrows`` rows (``(B nrows, BW)`` or more rows)."""
    BW = words.shape[-1]
    flat = words.reshape(-1, BW)
    u = torch.arange(B, device=words.device)[:, None] * nrows
    k = (u + torch.arange(T, device=words.device)[None, :]).reshape(-1)
    return flat[k]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _rounded(d: torch.Tensor, wd: torch.dtype) -> torch.Tensor:
    """``d`` as float32, each value rounded to the weights' dtype."""
    d = d.to(torch.float32)
    return d if wd == torch.float32 else d.to(wd).to(torch.float32)


def _gbits_reference(d: torch.Tensor, left: torch.Tensor,
                     wd: torch.dtype) -> torch.Tensor:
    """Plain version: ``left^T @ round(d)`` float32 ``(J, H)`` from ``d (K,
    H)`` and the 0/1 ``left (K, J)``; on a card run it with
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    return left.to(torch.float32).T @ _rounded(d, wd)


def exact_sum(d: torch.Tensor, left: torch.Tensor,
              wd: torch.dtype) -> torch.Tensor:
    """``left^T @ round(d)`` in float64: the exact sum of the operands the
    kernel sees (a float64 product of 0/1 and bf16-rounded or float32
    values is exact; the sum of up to ``2**29`` of them loses nothing a
    float32 result keeps)."""
    return left.to(torch.float64).T @ _rounded(d, wd).to(torch.float64)


def _row_ranges(B: int, groups: int, device):
    """Block ``y``'s batch rows ``[b0[y], b1[y])``: ``[y B / groups, (y +
    1) B / groups)``."""
    y = torch.arange(groups, dtype=torch.int64, device=device)
    return y * B // groups, (y + 1) * B // groups


def _slices(B: int, T: int, groups: int, step_major: bool, device):
    """The k16 slices of the ``groups`` blocks in their order, one ``(groups,
    16)`` tensor of row indices of the ``(B T, ·)`` views a turn (``B T``,
    a zero row, past a block's rows or slices)."""
    b0, b1 = _row_ranges(B, groups, device)
    C = (b1 - b0 + SLICE - 1) // SLICE
    r = torch.arange(SLICE, device=device)
    for s in range(int((C * T).max())):
        t, c = s // C, s % C
        b = b0[:, None] + SLICE * c[:, None] + r[None, :]
        k = t[:, None] * B + b if step_major else b * T + t[:, None]
        live = (s < C * T)[:, None] & (b < b1[:, None])
        yield torch.where(live, k, torch.full_like(k, B * T))


def _gbits_ordered_reference(d: torch.Tensor, left: torch.Tensor, B: int,
                             T: int, groups: int, wd: torch.dtype,
                             step_major: bool = False) -> torch.Tensor:
    """Plain version of ``gbits_mma`` in its summation order: ``(J, H)``
    float32 from ``d (B T, H)`` and the 0/1 ``left (B T, J)`` (rows ``b T +
    t``, or ``t B + b`` with ``step_major``).  Block ``y`` of ``groups`` (the
    plan's row groups) walks its slices (:func:`_slices`); per slice the
    product with ``d``'s bf16 piece (bf16 weights) or, for float32 weights,
    the hi piece's apart and the lo then the mid piece's into a second
    accumulator, ``small + big`` added to the block's float32 slab; the
    slabs are added in float64 and rounded once (``fused.gbits_sums``), as
    the wrappers add the kernel's.  Each tensor-core
    product is taken exactly (float64) and rounded once to nearest: the card
    truncates inside a slice where the exact sum does not fit float32, which
    this does not follow."""
    f32, f64 = torch.float32, torch.float64
    H, J = d.shape[1], left.shape[1]
    dev = d.device
    dr = _rounded(d, wd)
    zero_d = torch.zeros((1, H), dtype=f32, device=dev)
    pieces = [torch.cat([p, zero_d]).to(f64)
              for p in (split_pieces(dr) if wd == f32 else [dr])]
    lp = torch.cat([left.to(f64), torch.zeros((1, J), dtype=f64,
                                              device=dev)])
    acc = torch.zeros((groups, J, H), dtype=f32, device=dev)
    for k in _slices(B, T, groups, step_major, dev):
        a = lp[k].transpose(1, 2)
        big = (a @ pieces[0][k]).to(f32)
        if len(pieces) == 1:
            acc = acc + big
            continue
        small = (a @ pieces[2][k]).to(f32)
        small = (small.to(f64) + a @ pieces[1][k]).to(f32)
        acc = acc + (small + big)
    return _f.gbits_sums(acc.view(groups, J * H), None).view(J, H)


def walk_groups(units: int, T: int, J: int, H: int, wide: bool,
                device=None) -> int:
    """The row groups of the CUDA-core bit walks ``gbits_mma`` replaced
    (``bwd_gbits`` a batch row of ``T`` steps a turn, 32 rows j a thread;
    ``wide``: ``rec_scan.cu:rec_gw``, 32 columns a block), from their plans
    and the card's SM count and shared memory (an H100's where ``device``
    is no card)."""
    sms, sm_smem = 132, 233472
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(device)
        sms = props.multi_processor_count
        sm_smem = getattr(props, "shared_memory_per_multiprocessor", sm_smem)

    def a16(x):
        return (x + 15) // 16 * 16

    HP = (H + 31) // 32 * 32
    BW = (J + 31) // 32
    if wide:
        HW = (H + 31) // 32
        G = min(HW, 16)
        smem, threads = a16(T * 128) + T * G * 4, 32 * G
        per_group = -(-HW // G) * HW
    else:
        G = max(512 // HP, 1)
        smem, threads = a16(T * HP * 4) + a16((T + 1) * BW * 4), HP * G
        per_group = -(-BW // G)
    per_sm = max(min(sm_smem // (smem + 1024), 1024 // threads), 1)
    return max(min(sms * per_sm // per_group, units), 1)


def _gbits_walk_reference(d: torch.Tensor, left: torch.Tensor, B: int,
                          T: int, groups: int, wd: torch.dtype,
                          step_major: bool = False) -> torch.Tensor:
    """The parent's order: block ``i`` of ``groups`` walked the batch rows
    ``i, i + groups, ..`` and each row's steps in ascending order, adding
    ``round(d(b, t))[h]`` to its float32 sum where bit ``j`` of ``(b, t)``
    is set; the slabs are added in a fixed order.  Operands as
    :func:`_gbits_ordered_reference`."""
    f32 = torch.float32
    H, J = d.shape[1], left.shape[1]
    dev = d.device
    shape = (T, B) if step_major else (B, T)
    dr = _rounded(d, wd).view(*shape, H)
    lf = left.to(f32).view(*shape, J)
    if step_major:
        dr, lf = dr.transpose(0, 1), lf.transpose(0, 1)
    acc = torch.zeros((groups, J, H), dtype=f32, device=dev)
    j = torch.arange(groups, device=dev)
    for turn in range(-(-B // groups)):
        u = turn * groups + j
        live = (u < B).to(f32)[:, None, None]
        u = u.clamp(max=B - 1)
        for t in range(T):
            acc = acc + (lf[u, t][:, :, None] * live) * dr[u, t][:, None, :]
    return _f.slab_sums(acc.view(groups, J * H), None).view(J, H)


# ---------------------------------------------------------------------------
# CPU twins of the kernel's fragments
# ---------------------------------------------------------------------------
BF16_ONE = 0x3F80


def _slice_rows(q: int) -> Tuple[int, int, int, int]:
    """The slice rows that lane quad ``q``'s k slots ``2q, 2q + 1, 2q + 8,
    2q + 9`` hold: the same rows (``gbits_mma.cuh`` reads B of those rows
    by ``ldmatrix.trans``, or one load a value, from the stage)."""
    return 2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9


def a_fragment(words: torch.Tensor, j0: int) -> List[List[int]]:
    """Twin of ``gbits_mma.cuh:build_a``: the A fragment registers (four
    32-bit words a lane, bf16 1.0 or 0 in each half) of the m16 tile of rows
    ``j0 .. j0 + 15`` for one k16 slice, from the slice's 16 rows of mask
    words ``words (16, BW)``."""
    w = words.to(torch.int64).tolist()

    def bit(r, j):
        return (w[r][j // 32] >> (j % 32)) & 1

    regs = []
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        r0, r1, r2, r3 = _slice_rows(q)
        rows = ((r0, r1, j0 + g), (r0, r1, j0 + g + 8),
                (r2, r3, j0 + g), (r2, r3, j0 + g + 8))
        regs.append([(bit(a, j) * BF16_ONE) | (bit(b, j) * BF16_ONE << 16)
                     for a, b, j in rows])
    return regs


def _bf16_word(x: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns of float32 values that are bf16 values."""
    return (x.to(torch.float32).view(torch.int32).to(torch.int64) >> 16) \
        & 0xFFFF


def b_fragment(d: torch.Tensor, wd: torch.dtype) -> List[List[List[int]]]:
    """Twin of the kernel's B loads: the B fragment words of one k16 slice
    and n8 tile, ``d (16, 8)`` (slice rows x columns), each value rounded
    to ``wd`` and split into its pieces (three for float32, one for bf16),
    largest first: ``[lane][piece] = [b0, b1]``."""
    dr = _rounded(d, wd)
    pieces = [_bf16_word(p) for p in
              (split_pieces(dr) if wd == torch.float32 else [dr])]
    out = []
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        r0, r1, r2, r3 = _slice_rows(q)
        out.append([[int(p[r0, g] | (p[r1, g] << 16)),
                     int(p[r2, g] | (p[r3, g] << 16))] for p in pieces])
    return out


def _bf16_value(h: int) -> float:
    return struct.unpack("<f", struct.pack("<I", (h & 0xFFFF) << 16))[0]


def fragment_product(a: List[List[int]],
                     b: List[List[List[int]]]) -> torch.Tensor:
    """The (16, 8) product mma.m16n8k16 forms from A and B fragments, read
    by the instruction's layout (lane ``4 g + q``: A registers 0..3 hold
    rows ``g, g + 8, g, g + 8`` at k ``2q, 2q + 1`` (registers 0, 1) and
    ``2q + 8, 2q + 9`` (2, 3), the lower k in the low half; B registers 0
    and 1 hold column ``g`` at k ``2q, 2q + 1`` and ``2q + 8, 2q + 9``),
    summed over the pieces in float64."""
    f64 = torch.float64
    A = torch.zeros((16, 16), dtype=f64)
    Bs = [torch.zeros((16, 8), dtype=f64) for _ in b[0]]
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for reg, (row, kb) in enumerate(((g, 2 * q), (g + 8, 2 * q),
                                         (g, 2 * q + 8), (g + 8, 2 * q + 8))):
            A[row, kb] = _bf16_value(a[lane][reg] & 0xFFFF)
            A[row, kb + 1] = _bf16_value(a[lane][reg] >> 16)
        for p, (b0, b1) in enumerate(b[lane]):
            for word, kb in ((b0, 2 * q), (b1, 2 * q + 8)):
                Bs[p][kb, g] = _bf16_value(word & 0xFFFF)
                Bs[p][kb + 1, g] = _bf16_value(word >> 16)
    return sum(A @ Bp for Bp in Bs)


# ---------------------------------------------------------------------------
# The CUDA kernel on its own
# ---------------------------------------------------------------------------
def _declare(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.snn_gbits_plan.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.snn_gbits_plan.restype = i
    lib.snn_gbits.argtypes = [vp, vp, vp] + [i] * 7 + [ll] + [i] * 5 + [vp]
    lib.snn_gbits.restype = i
    lib.snn_cuda_error_string.argtypes = [i]
    lib.snn_cuda_error_string.restype = ctypes.c_char_p
    lib._snn_declared = True


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("gbits")
    if not getattr(lib, "_snn_declared", False):
        _declare(lib)
    return lib


def plan(device, B: int, T: int, J: int, H: int, d_dtype: torch.dtype,
         wd: torch.dtype) -> Optional[dict]:
    """``gbits_mma``'s plan at a shape on ``device``: ``groups`` (row
    groups, one slab each; block ``y`` sums the batch rows ``[y B / groups,
    (y + 1) B / groups)``) and ``ring`` (``d`` streams through the TMA
    ring; False: the threads copy it, as ``H`` times ``d``'s itemsize is not
    a multiple of 16 bytes or below 128, or the batch is below 16 rows);
    None where the shape does not fit."""
    lib = _lib()
    out = (ctypes.c_int * 2)()
    rc = lib.snn_gbits_plan(B, T, J, H, int(d_dtype == torch.bfloat16),
                            int(wd == torch.bfloat16),
                            _f._index(torch.device(device)), out)
    if rc == 1:
        return None
    _f._raise_on(rc, lib, f"{KERNEL_GBITS} plan")
    return {"groups": out[0], "ring": bool(out[1])}


def _launch(d: torch.Tensor, words: torch.Tensor, slab: torch.Tensor,
            J: int, B: int, T: int, nrows: int, wd: torch.dtype, groups: int,
            S: Optional[int], step_major: bool = False) -> None:
    """One launch of ``gbits_mma`` into ``slab ([S,] groups, J H)``: what
    :func:`gbits` and the backwards' calls do besides adding the slabs."""
    H = d.shape[-1]
    lib = _lib()
    rc = lib.snn_gbits(
        d.data_ptr(), words.data_ptr(), slab.data_ptr(), B, T,
        int(step_major), nrows, words.shape[-1], J, H,
        words[0].numel() if S else 0, S or 1,
        int(d.dtype == torch.bfloat16), int(wd == torch.bfloat16), groups,
        _f._index(d.device), torch.cuda.current_stream(d.device).cuda_stream)
    _f._raise_on(rc, lib, f"{KERNEL_GBITS} launch")
    _f._launched_function(KERNEL_GBITS)


def gbits(d: torch.Tensor, words: torch.Tensor, J: int, B: int, T: int,
          nrows: int, wd: torch.dtype, step_major: bool = False
          ) -> torch.Tensor:
    """``sum over (b, t) of bit(b, t)^T round(d(b, t))``: ``(J, H)`` float32
    from ``d ([S,] B T, H)`` (the weights' dtype, or float32; row ``b T +
    t``) and the mask words ``words ([S,] B nrows, BW)`` (row ``b nrows +
    t``), ``(S, J, H)`` for a leading S; with ``step_major`` rows ``t B +
    b`` of both (no S).  On a CUDA tensor ``gbits_mma`` (its slabs added in
    a fixed order), else the plain version."""
    S = d.shape[0] if d.dim() == 3 else None
    H = d.shape[-1]
    BW = words.shape[-1]
    rows = B * T if step_major else B * nrows
    if (d.shape[-2] != B * T or BW < (J + 31) // 32
            or words.shape[-2] < rows or (step_major and S is not None)
            or (not step_major and nrows < T)):
        raise ValueError(f"{KERNEL_GBITS}: d {tuple(d.shape)} and mask "
                         f"words {tuple(words.shape)} do not hold B={B} "
                         f"rows of T={T} steps (nrows={nrows}) and J={J}")
    if d.device.type != "cuda":
        if step_major:
            return _gbits_reference(d, unpack_bits(words[:B * T], J), wd)
        ds = [d] if S is None else list(d)
        ws = [words] if S is None else list(words)
        outs = [_gbits_reference(x, unpack_bits(_rows_of(w, B, T, nrows),
                                                J), wd)
                for x, w in zip(ds, ws)]
        return outs[0] if S is None else torch.stack(outs)
    if d.dtype not in (torch.float32, wd) or wd not in (torch.float32,
                                                       torch.bfloat16):
        raise ValueError(f"{KERNEL_GBITS}: d must be float32 or the "
                         f"weights' dtype {wd}, got {d.dtype}")
    for name, t, dt in (("d", d, d.dtype), ("words", words, torch.int32)):
        _f._check(KERNEL_GBITS, name, t, dt, tuple(t.shape), d.device)
    p = plan(d.device, B, T, J, H, d.dtype, wd)
    if p is None:
        raise ValueError(f"{KERNEL_GBITS}: shape J={J} H={H} does not fit")
    slab = torch.empty((S or 1, p["groups"], J * H), dtype=torch.float32,
                       device=d.device)
    _launch(d, words, slab, J, B, T, nrows, wd, p["groups"], S, step_major)
    if S is None:
        return _f.gbits_sums(slab[0], None).view(J, H)
    return _f.gbits_sums(slab, S).view(S, J, H)
