"""Can a plain version hold the bits of ``bwd_gout``'s tensor-core form?

``csrc/gout_mma.cuh`` (``bwd_gout_mma_kernel``) forms g_W_out = sum over rows
of z^T s_r as m16n8k16 products, one k16 slice of a row's steps each, into
fresh accumulators added in float32; the main path's ``bwd_gout`` adds
z(t) s_r(t) as fused multiply-adds, which ``ops/fused.py:
_gout_ordered_reference`` reproduces bit for bit.  This probe runs both on
the same inputs (the tensor-core one through ``tools/bwd_ablation.py``'s
``gout_mma`` variant of ``fused_head_bwd``) and prints, for each case, the
share of g_W_out's elements each kernel gives bitwise equal to a plain
version in its own order (:func:`mma_ordered`: each slice's products summed
exactly in float64 and rounded once to nearest), each kernel's error against
the exact (float64) sum as a share of max|g|, and whether g_b agrees.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.gout_mma_probe

Cases: the flagship net (784 -> ALIF-H recurrent, learn_beta, O = 10, init
weights from seed 0, random pixels from seed 1, a normal cotangent from
seed 6) at B = 37, F = 30, H = 20, 45, 128 and at B = 8192, F = 784,
H = 128; TTFS and periodic, T = 24 and 100 at tau = 20 and the production
tau 20e-3, float32 and bfloat16 weights.  One JSON line a case, then the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import LayerType, SNNConfig
from ..models import snn as model_lib
from ..ops import _build, fused
from ..ops.cells import masked_recurrent
from ..ops.encoding import pixels_to_firing_periods
from ..ops.head_mma import split_pieces
from . import bwd_ablation

SHAPES = [(37, 30, 20), (37, 30, 45), (37, 30, 128), (8192, 784, 128)]
STEPS = [(24, 20.0), (24, 20e-3), (100, 20.0), (100, 20e-3)]


def mma_ordered(z: torch.Tensor, s_r: torch.Tensor, wd: torch.dtype,
                groups: int, rows: int) -> torch.Tensor:
    """g_W_out ``(H, O)`` in ``bwd_gout_mma_kernel``'s order from ``z (T, B,
    H)`` (0/1) and the rounded chains ``s_r (T, B, O)``: block ``j`` of
    ``groups`` walks its rows (``fused._block_rows``) and each row's k16
    slices of steps in ascending order; a slice adds ``small + big`` to the
    block's float32 slab, ``big`` the product with ``s_r``'s hi piece and,
    for float32 weights, ``small`` the lo piece's product then the mid
    piece's added to it (``head_mma.cuh:mma_exact``), each product summed
    exactly and rounded once to nearest.  The slabs are added as the
    wrapper adds the kernel's."""
    f64 = torch.float64
    T, B, H = z.shape
    O = s_r.shape[2]
    pieces = split_pieces(s_r) if wd == torch.float32 else [s_r]
    slab = torch.zeros((groups, H, O), dtype=torch.float32, device=z.device)
    for b, live in _rows(B, groups, rows, z.device):
        for t0 in range(0, T, 16):
            zt = z[t0:t0 + 16, b].permute(1, 2, 0).to(f64)  # (groups, H, k)
            ps = [p[t0:t0 + 16, b].permute(1, 0, 2).to(f64) for p in pieces]
            big = (zt @ ps[0]).float()
            part = big
            if len(ps) == 3:
                small = (zt @ ps[2]).float()
                small = (small.to(f64) + zt @ ps[1]).float()
                part = small + big
            slab = slab + torch.where(live[:, None, None], part,
                                      torch.zeros_like(part))
    return fused.slab_sums(slab.view(groups, H * O), None).view(H, O)


def _rows(B, groups, rows, dev):
    for b, live in fused._block_rows(B, groups, rows):
        yield b.to(dev), live.to(dev)


def _case(B, F, H, T, tau, periodic, md):
    """The forward's residuals and a cotangent for one case."""
    cfg = SNNConfig(input_size=F, output_size=10, n_hidden_neurons=H,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=T, matmul_dtype=str(md).split(".")[1])
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=float(T), tau=tau).contiguous()
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, ro = params["input"], params["readout"]
    w_in = p0["w_in"].to(md).contiguous()
    w_rec = masked_recurrent(lcfg, p0).to(md).contiguous()
    w_out = ro["w_in"].to(md).contiguous()
    _, delta, _, tstar, _ = fused._head_train_cuda(
        lat, w_in, w_rec, p0["beta"], w_out, ro["b"].contiguous(), T,
        periodic, True, lcfg.alpha, lcfg.rho, lcfg.threshold, rcfg.kappa,
        True, False, False)
    g_logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 10)).astype(np.float32)).cuda()
    args = (g_logits, None, tstar, delta, None, lat, w_in, w_rec, p0["beta"],
            w_out, T, periodic, lcfg.alpha, lcfg.threshold, lcfg.gamma,
            rcfg.kappa, lcfg.spike_func)
    return args, rcfg.kappa


def _kernel_out(lib, args):
    _build._libs["fused_head_bwd"] = lib  # what fused._lib() loads
    keep: dict = {}
    grads = fused._head_bwd_cuda(*args, keep=keep)
    torch.cuda.synchronize()
    return keep["g_w_out"], grads[3]


def _share_equal(a, b):
    return float((a.contiguous().view(torch.int32) ==
                  b.contiguous().view(torch.int32)).float().mean())


def _rel_err(got, exact):
    scale = float(exact.abs().max()) or 1.0
    return float((got.double() - exact).abs().max()) / scale


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gout_mma_probe needs a CUDA card")
    old, new = bwd_ablation.VARIANTS["gout_mma"]
    source = _build.inlined_source("fused_head_bwd")
    if source.count(old) != 1:
        raise SystemExit("gout_mma: statement not found once in the source")
    libs = {"fma": _build.load("fused_head_bwd"),
            "mma": ctypes.CDLL(str(bwd_ablation._variant_so(
                "gout_mma", source.replace(old, new))))}
    try:
        for B, F, H in SHAPES:
            for T, tau in STEPS:
                for periodic in (False, True):
                    for md in (torch.float32, torch.bfloat16):
                        args, kappa = _case(B, F, H, T, tau, periodic, md)
                        order = fused.gradient_plan(
                            "cuda", B, F, H, 10, T, True,
                            md == torch.bfloat16, periodic)
                        g_logits, tstar, delta = args[0], args[2], args[3]
                        z = (delta >= 0).float()
                        s_r, _ = fused._s_chains(g_logits, tstar, kappa, md,
                                                 T)
                        exact = torch.einsum("tbh,tbo->ho", z.double(),
                                             s_r.double())
                        fma_w, fma_b = _kernel_out(libs["fma"], args)
                        mma_w, mma_b = _kernel_out(libs["mma"], args)
                        fma_plain, _ = fused._gout_ordered_reference(
                            z, g_logits, tstar, kappa, md,
                            order["groups_out"], order["rows_out"])
                        mma_plain = mma_ordered(z, s_r, md,
                                                order["groups_out"],
                                                order["rows_out"])
                        print(json.dumps({
                            "B": B, "F": F, "H": H, "T": T, "tau": tau,
                            "encoding": "periodic" if periodic else "ttfs",
                            "matmul_dtype": str(md).split(".")[1],
                            "fma_equal_share": _share_equal(fma_w, fma_plain),
                            "mma_equal_share": _share_equal(mma_w, mma_plain),
                            "fma_err": _rel_err(fma_w, exact),
                            "mma_err": _rel_err(mma_w, exact),
                            "mma_plain_err": _rel_err(mma_plain, exact),
                            "g_b_equal": bool(torch.equal(fma_b, mma_b)),
                        }), flush=True)
    finally:
        _build._libs["fused_head_bwd"] = libs["fma"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
