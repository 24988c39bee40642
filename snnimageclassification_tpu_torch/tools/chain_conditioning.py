"""How far apart do two float32 orders of the recurrent scan's chain land?

``rec_scan_bwd``'s chain carries ``dcur`` back over T steps through
``dcur @ W_rec^T`` and the surrogate; where it amplifies, the last bits of
any float32 summation order grow into its result.  For the inputs of
``tests/test_torch_cuda.py::_rec_check`` (B = 37, H = 20 and 40, T = 100,
numpy seed 13; LIF/ALIF x FastSigmoid/Phi) this prints, on the residuals of
the forward in the cluster body's order (``_fwd_ordered_reference``, the
card's bits) and of the order-free forward (``_fwd_reference``), the chain's
g_i of ``_bwd_reference`` (float32), of the same chain with its product's
k order reversed (float32), and of the chain in float64, each pair's
largest difference as a share of max|g|.  The card tests hold the kernel
within 5e-6 of ``_bwd_reference`` at T = 100.

Runs on the CPU (no card needed)::

    python3 -m snnimageclassification_tpu_torch.tools.chain_conditioning
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import fused, rec_scan
from ..ops.cells import ALIFConfig, LIFConfig
from ..ops.surrogate import SpikeFuncType, surrogate_grad_from_delta

CASES = [("alif-fs", True, SpikeFuncType.FastSigmoid),
         ("alif-phi", True, SpikeFuncType.Phi),
         ("lif-fs", False, SpikeFuncType.FastSigmoid),
         ("lif-phi", False, SpikeFuncType.Phi)]


def chain(bw, product, dtype):
    """g_i of ``_bwd_reference``'s chain in ``dtype``, ``product(d)`` the
    recurrent cotangent of ``dcur(t+1)``."""
    g_z, z, res, a_tr, res_is_v, _, beta, alpha, thr, gamma, spike = bw
    T, B, H = res.shape
    dcur = torch.zeros((B, H), dtype=dtype, device=res.device)
    out = []
    for t in range(T - 1, -1, -1):
        th = thr + beta * a_tr[t].to(dtype) if a_tr is not None else thr
        delta = res[t].to(dtype) - th if res_is_v else res[t].to(dtype)
        surr = surrogate_grad_from_delta(spike, delta, th, gamma)
        dv = (g_z[t].to(dtype) + product(dcur)) * surr + alpha * dcur
        z_prev = z[t - 1].to(dtype) if t > 0 else torch.zeros_like(dcur)
        dcur = dv * (1.0 - z_prev)
        out.append(dcur)
    return torch.stack(out[::-1])


def share(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def main() -> None:
    B, T = 37, 100
    for name, alif, spike in CASES:
        cfg = (ALIFConfig if alif else LIFConfig)(input_size=1,
                                                  output_size=1)
        alpha, rho = cfg.alpha, cfg.rho if alif else 0.0
        beta = 1.6 if alif else 0.0
        for H in (20, 40):
            rng = np.random.default_rng(13)
            cur = torch.from_numpy(
                (0.3 + 0.6 * rng.standard_normal((T, B, H)))
                .astype(np.float32))
            w = torch.from_numpy((1.3 / np.sqrt(H) * rng.standard_normal(
                (H, H))).astype(np.float32)) * (1 - torch.eye(H))
            g_z = torch.from_numpy(
                rng.standard_normal((T, B, H)).astype(np.float32))
            res_is_v = fused._residual_is_v(alif, spike)
            row = {"case": name, "H": H}
            for kind, forward in (("ordered", rec_scan._fwd_ordered_reference),
                                  ("plain", rec_scan._fwd_reference)):
                z, res, a_tr = forward(cur, w, beta, alif, alpha, rho,
                                       cfg.threshold, True,
                                       fused._stores_a(alif, spike), res_is_v)
                bw = (g_z, z, res, a_tr, res_is_v, w, beta, alpha,
                      cfg.threshold, cfg.gamma, spike)
                plain = rec_scan._bwd_reference(*bw)[0]
                w64 = w.double()
                exact = chain(bw, lambda d: d @ w64.T, torch.float64)
                rev = chain(bw, lambda d: d.flip(1) @ w.T.flip(0),
                            torch.float32)
                row[f"{kind} forward"] = {
                    "plain vs float64": share(plain, exact),
                    "reversed vs float64": share(rev, exact),
                    "reversed vs plain": share(rev, plain)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
