"""Which model of the tensor cores' sums reproduces the chains' bits?

The backward chains on tensor cores form ``dcur @ W_rec^T`` (and the head's
``s @ W_out^T``) per k16 slice, each slice to fresh accumulators added in
float32 (``csrc/head_mma.cuh:mma_split_a``).  Their plain versions in that
order (``ops/fused.py:_split_slice_product``) take each slice's product
either exactly and rounded once to nearest (the default) or as
``_mma_slice`` models the card's accumulation (``card=True``: terms and sum
truncated toward zero).  This probe runs each chain on the card and prints
the share of its cotangents that equal the plain version bit for bit under
each model, over every element and over the chain's first step, which has
no recurrent product (the element-wise chain alone).

Chains: the LIF/ALIF head's (``csrc/chain_mma.cuh``: the rounded dcur of
``fused_head_bwd``, ALIF recurrent, B = 64, F = 48, H = 45, O = 10; TTFS
with Phi and periodic with FastSigmoid at tau = 20, T = 24 and 100, float32
and bfloat16 weights) and the wide scan's (``csrc/rec_mma.cuh``: g_i of
``rec_scan_bwd``, ALIF FastSigmoid, bfloat16 weights at B = 37, H = 20,
40, 200, 300, 512, 1024 and 256 rows of B = 8191, H = 512, T = 100; the
float32 chain runs on CUDA cores).

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.chain_model_probe

One JSON line a chain kind and type (equal elements / elements under each
model, all steps and the first step), then the card's name and power
limit.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..ops import fused, rec_scan
from ..ops.cells import ALIFConfig, ReadoutConfig
from ..ops.encoding import pixels_to_firing_periods, spike_row
from ..ops.surrogate import SpikeFuncType

MODELS = ("nearest", "card")


class Tally:
    """Equal elements and elements, per model, all steps and first step."""

    def __init__(self):
        self.n = {(m, k): [0, 0] for m in MODELS for k in ("all", "first")}

    def add(self, got, want_of, first):
        for m in MODELS:
            want = want_of(m == "card")
            for k, a, b in (("all", got, want),
                            ("first", first(got), first(want))):
                self.n[m, k][0] += int((a == b).sum())
                self.n[m, k][1] += b.numel()

    def shares(self):
        return {f"{m} {k}": f"{e}/{n} = {e / n:.6f}"
                for (m, k), (e, n) in self.n.items()}


def head_cases(tally, wd):
    """The head chain at its shapes: the kernel's rounded dcur against the
    plain loop of ``_head_bwd_ordered_reference`` under each model."""
    B, F, H, O = 64, 48, 45, 10
    cfg = ALIFConfig(input_size=F, output_size=H)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    for T in (24, 100):
        for periodic, spike in ((False, SpikeFuncType.Phi),
                                (True, SpikeFuncType.FastSigmoid)):
            rng = np.random.default_rng(T + periodic)

            def w(shape, std):
                return torch.from_numpy((std * rng.standard_normal(shape))
                                        .astype(np.float32)).cuda()

            pixels = torch.from_numpy(
                rng.random((B, F)).astype(np.float32)).cuda()
            lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                           tau=20.0).contiguous()
            w_in = w((F, H), 0.5).to(wd)
            w_rec = (w((H, H), 0.3) * (1 - torch.eye(H, device="cuda"))
                     ).to(wd)
            w_out, b_out = w((H, O), 1.0).to(wd), w((O,), 0.1)
            store_a = fused._stores_a(True, spike)
            _, delta, a_tr, tstar, _ = fused._head_train_cuda(
                lat, w_in, w_rec, 1.6, w_out, b_out, T, periodic, True,
                cfg.alpha, cfg.rho, cfg.threshold, kappa, True, store_a,
                False)
            g_logits = w((B, O), 1.0)
            keep = {}
            fused._head_bwd_cuda(g_logits, None, tstar, delta, a_tr, lat,
                                 w_in, w_rec, 1.6, w_out, T, periodic,
                                 cfg.alpha, cfg.threshold, cfg.gamma, kappa,
                                 spike, keep=keep)

            def loop(card):
                dc = torch.zeros((B, T, H), dtype=torch.float32,
                                 device="cuda")
                fused._bwd_loop(
                    lambda t: spike_row(lat, t, T, periodic).float(), None,
                    g_logits, None, tstar, None, delta, a_tr, None, False,
                    w_rec, 1.6, w_out, T, cfg.alpha, cfg.threshold,
                    cfg.gamma, kappa, spike, wd, dcur_out=dc,
                    matmul=lambda a, m: fused._split_slice_product(
                        a, m.contiguous(), wd, card=card))
                return dc

            tally.add(keep["dcur"].float(), loop, lambda x: x[:, T - 1])


def wide_case(tally, B, H, rows, seed):
    """The wide scan's bf16 chain at one shape on ``rows`` of its batch."""
    T, md = 100, torch.bfloat16
    cfg = ALIFConfig(input_size=H, output_size=H)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen, device="cuda")

    cur = normal((T, B, H), 0.6, 0.3)
    w = (normal((H, H), 1.3 / np.sqrt(H))
         * (1 - torch.eye(H, device="cuda"))).to(md)
    z, res, _ = rec_scan._fwd_cuda(cur, w, 1.6, True, cfg.alpha, cfg.rho,
                                   cfg.threshold, True, False, False)
    g_z = normal((T, B, H), 1.0 / B).to(md)
    bw = (g_z, z, res, None, False, w, 1.6, cfg.alpha, cfg.threshold,
          cfg.gamma, SpikeFuncType.FastSigmoid)
    g_i = rec_scan._bwd_cuda(*bw)[0]
    sub = tuple(x[:, rows].contiguous() if i < 3 else x
                for i, x in enumerate(bw))
    tally.add(g_i[:, rows], lambda card: rec_scan._chain_ordered_reference(
        *sub, card=card), lambda x: x[T - 1])


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    for wd in (torch.float32, torch.bfloat16):
        tally = Tally()
        head_cases(tally, wd)
        print(json.dumps({"chain": "head", "matmul_dtype": str(wd)[6:],
                          **tally.shares()}), flush=True)
    tally = Tally()
    if rec_scan.rec_bodies(100, 512, itemsize=2)[1] != "mma":
        raise SystemExit("the bf16 wide chain is not on the cluster body")
    for i, H in enumerate((20, 40, 200, 300, 512, 1024)):
        wide_case(tally, 37, H, torch.arange(37, device="cuda"), i)
    B, h = 8191, 128
    wide_case(tally, B, 512, torch.cat([torch.arange(h),
                                        torch.arange(B - h, B)]).cuda(), 7)
    print(json.dumps({"chain": "wide", "matmul_dtype": "bfloat16",
                      **tally.shares()}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())


if __name__ == "__main__":
    main()
