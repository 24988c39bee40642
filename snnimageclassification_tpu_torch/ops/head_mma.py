"""CPU twins of the head kernel pair's tensor-core body.

The mma body of ``csrc/fused_head.cu`` and ``csrc/fused_head_bwd.cu``
(``csrc/head_mma.cuh``) takes its products on bf16 tensor cores and its
input current from per-row feature lists.  Two parts of that design are
arithmetic that a CPU can check, and these functions are their twins:

* the split of a float32 operand into three bf16 pieces, ``hi = bf16(x)``,
  ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, whose sum is ``x``
  exactly, and the products the kernels take from the pieces: three for a
  0/1 left operand (``z @ W``, exact pieces of an exact operand), six for a
  float32 one (``dcur @ W_rec^T``: the piece pairs ``(i, j)`` with ``i + j
  <= 2``, smallest first, as ``head_mma.cuh:mma_split_a`` issues them);
* the per-row feature lists of ``head_sort_kernel``: each row's features
  ordered by spike key (TTFS the latency, periodic the clamped period),
  ascending ``f`` within a key, with the nonempty keys and the end of each
  key's run, in the kernel's 16-bit layout; and the runs a step reads.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "PRODUCT_TERMS",
    "split_pieces",
    "split_matmul",
    "spike_keys",
    "list_row_words",
    "head_lists",
    "step_runs",
    "every_step_run",
]

# The piece pairs (i of the left operand, j of the right) of a float32 left
# operand's product, in the order the kernel issues them; 0 is hi.
PRODUCT_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def split_pieces(x: torch.Tensor, n: int = 3) -> List[torch.Tensor]:
    """``x`` (float32) as ``n`` float32 tensors of bf16 values, largest
    first, each the bf16 rounding (to nearest even) of what the earlier
    ones leave; for n = 3 they sum to ``x`` exactly."""
    rest = x.to(torch.float32)
    out = []
    for _ in range(n):
        piece = rest.to(torch.bfloat16).to(torch.float32)
        out.append(piece)
        rest = rest - piece
    return out


def split_matmul(a: torch.Tensor, w: torch.Tensor, exact_a: bool,
                 terms: Sequence[Tuple[int, int]] = PRODUCT_TERMS
                 ) -> torch.Tensor:
    """``a @ w`` as the mma body forms it for float32 weights, each product
    of pieces and their sum in float64: three products ``a @ w_j`` where
    ``a`` is exact in bf16 (spikes), else the products of ``terms``."""
    wp = [p.double() for p in split_pieces(w)]
    if exact_a:
        a64 = a.double()
        return sum(a64 @ wp[j] for j in (2, 1, 0))
    ap = [p.double() for p in split_pieces(a)]
    return sum(ap[i] @ wp[j] for i, j in terms)


def _align8(x: int) -> int:
    return (x + 7) & ~7


def list_row_words(n_features: int) -> int:
    """16-bit words of one row of the kernels' list scratch."""
    return 3 * _align8(n_features) + 8


def spike_keys(lat: torch.Tensor, n_steps: int, use_periods: bool
               ) -> torch.Tensor:
    """``head_common.cuh:enc_key``: the spike key of each latency, -1 for
    a feature that never fires."""
    if use_periods:
        if n_steps >= 2:
            return torch.clamp(lat, 1, n_steps - 1)
        return torch.zeros_like(lat)
    return torch.where((lat >= 0) & (lat < n_steps), lat,
                       torch.full_like(lat, -1))


def head_lists(lat: torch.Tensor, n_steps: int,
               use_periods: bool) -> torch.Tensor:
    """Twin of ``head_sort_kernel``: ``(B, list_row_words(F))`` int32 (the
    kernel's uint16 words).  A row: the features that fire at some step,
    ordered by key and ascending ``f`` within a key; at ``FA = align8(F)``
    the number ``nk`` of nonempty keys; at ``FA + 8`` those keys,
    ascending; at ``2 FA + 8`` the end of each key's run.  Words the kernel
    leaves unwritten are 0 here."""
    B, F = lat.shape
    FA = _align8(F)
    keys = spike_keys(lat.to(torch.int64).cpu(), n_steps, use_periods)
    out = torch.zeros((B, list_row_words(F)), dtype=torch.int32)
    for b in range(B):
        k = keys[b]
        fire = torch.nonzero(k >= 0).flatten()
        # A stable sort by key keeps ascending f within a key.
        order = fire[torch.sort(k[fire], stable=True).indices]
        out[b, :order.numel()] = order.to(torch.int32)
        uniq, counts = torch.unique_consecutive(k[order], return_counts=True)
        nk = uniq.numel()
        out[b, FA] = nk
        out[b, FA + 8:FA + 8 + nk] = uniq.to(torch.int32)
        out[b, 2 * FA + 8:2 * FA + 8 + nk] = torch.cumsum(counts, 0).to(
            torch.int32)
    return out


def _row_runs(row: torch.Tensor, n_features: int):
    FA = _align8(n_features)
    nk = int(row[FA])
    keys = row[FA + 8:FA + 8 + nk].tolist()
    ends = row[2 * FA + 8:2 * FA + 8 + nk].tolist()
    starts = [0] + ends[:-1]
    return keys, starts, ends


def every_step_run(row: torch.Tensor, n_features: int, n_steps: int,
                   use_periods: bool) -> Optional[Tuple[int, int]]:
    """The run of period 1 (it fires at every step t >= 1; periodic
    encoding, ``n_steps >= 2``), which the kernel sums once, or None."""
    if not (use_periods and n_steps >= 2):
        return None
    keys, starts, ends = _row_runs(row, n_features)
    if keys and keys[0] == 1:
        return starts[0], ends[0]
    return None


def step_runs(row: torch.Tensor, n_features: int, t: int, n_steps: int,
              use_periods: bool) -> List[Tuple[int, int]]:
    """The runs ``[start, end)`` of a list row that the kernel sums at step
    ``t``, in its order (``head_mma_fwd.cuh:step_runs``): TTFS the run of key
    ``t``; periodic the runs of the periods ``p <= t`` dividing ``t``,
    ascending, the run of period 1 aside (:func:`every_step_run`)."""
    keys, starts, ends = _row_runs(row, n_features)
    every = use_periods and n_steps >= 2
    out = []
    for k, s, e in zip(keys, starts, ends):
        if not use_periods:
            if k == t:
                out.append((s, e))
            continue
        if k > t:
            break
        if k == 1 and every:
            continue
        if k == 0 or t % k == 0:
            out.append((s, e))
    return out
