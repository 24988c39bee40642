"""Drive the PyTorch port on one CUDA card and check its kernels.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. device  -- require CUDA; print the card's name and power limit;
2. build   -- compile every kernel of the port from ``csrc/`` (nvcc,
   sm_90a, one process per source) and print the build seconds;
3. kernels -- each kernel's wrapper against its plain PyTorch version on
   the card.  ``fused_head_fwd``: four head variants x {float32,
   bfloat16} weights at a small shape (logits to atol=rtol=1e-5) and at
   the flagship shape (B=4096, 784-128-10, T=100: argmax equal on
   >= 99.5 % of rows, logits within 1e-4 * max|logit| on >= 99 % of
   rows).  ``fused_head_fwd_train`` and ``fused_head_bwd``: those four, a
   Phi case (two residuals) and a ``_counts`` case, at small shapes and
   at B=8192 of the flagship shape (``phase_train_kernels``);
4. serve   -- the flagship (784 -> ALIF-128 recurrent, learn_beta, T=100)
   served by ``InferenceServer`` at batch 4096 with uint8 wire input, for
   float32 and for bfloat16 matmul weights: 4 threads submit 16 requests
   of 512 rows; every result must equal a direct ``forward_logits_pixels``
   on the card bitwise, and the head kernel's launch count for that run
   must be non-zero.  Prints the server stats, served images/s and the
   kernel's time per 4096-row batch (CUDA events, median of 25);
5. train   -- ``Trainer`` on the flagship at batch 8192, float32 then
   bfloat16 matmul weights, TTFS, on a learnable synthetic task (10 class
   prototypes plus noise, numpy seed): 3 warm-up and 30 timed steps.  The
   losses must be finite and fall, beta must stay bitwise, every trained
   leaf must move, each step must launch the training forward and the
   backward kernel once and the inference kernel never, and the first
   step's gradients must agree with the plain backward.  Then 10 steps
   with periodic encoding for the times, and 3 with a count regularizer
   for the launches;
6. deep serve -- 784 -> 128 -> 128 -> 96 -> 10 (ALIF, recurrent,
   learn_beta, T=100) served as in 4: results bitwise equal to a direct
   forward, one ``fused_layer0_fwd`` and two ``fused_mid_fwd`` launches a
   batch; then each of the three kernels alone on a 4096-row batch against
   its plain version, timed, with its bound;
7. deep train -- the same network through ``Trainer`` at batch 8192 as in
   5: 3 warm-up and 20 timed TTFS steps (finite falling loss, every beta
   bitwise, every trained leaf moves, three forward and three backward
   launches a step), each of the six kernels alone on a training batch
   against its plain version (the backward ones on the forward kernel's
   residuals), 5 periodic steps and 3 with a count regularizer for times
   and launches;
8. Izhikevich kernels -- ``izh_scan_fwd/bwd``, ``fused_izh_fwd[_train]``,
   ``fused_izh_layer0_fwd`` and ``fused_izh[_layer0]_bwd`` against their
   plain versions at the JAX tests' scale (W_in 3e6, W_rec 5e5, default
   constants, where units fire; every case asserts that some do): ff/rec x
   FastSigmoid/Phi x TTFS/periodic x T = 24 and 100 x {float32, bfloat16}
   at small shapes (spikes, ``tstar`` and counts equal, logits 1e-5, ``v``
   1e-6 relative and 1e-3 mV, gradients on the same residuals 2e-6 of
   max|g|, 5e-6 at T = 100, 2**-7 bf16, equal bits on a repeated call),
   then 784-128-10 and
   784-128-128-10 at B = 8192, T = 100 (the share of rows with equal spikes,
   the head's row bars, gradients 1e-4 / 2**-7).  There dt a b = -6e-5,
   and the chain's u carry moves a gradient by less than those bars, so
   the three backward kernels are also held at dt = 30 (dt a b = -1.8),
   with init-scale weights, ff/rec, on their forward kernels' residuals:
   1e-4 of max|g| float32, 2**-7 bf16;
9. Izhikevich serve -- 784 -> Izhikevich-128 recurrent -> 10, T = 100,
   dt = 30 (at the default dt = 1e-3 no unit fires at the init scale)
   served as in 4, f32 and bf16: results bitwise equal to a direct forward,
   one ``fused_izh_fwd`` launch a batch; the kernel alone timed.  At dt =
   30 the cell is unstable between spikes, so the kernel and its plain
   version (torch.matmul sums) part on some rows; a second plain version
   with every sum in the kernel's order must equal the kernel bitwise on
   256 rows (``ordered_izh_head``);
10. Izhikevich train -- that network through ``Trainer`` at batch 8192,
   TTFS (3 warm-up, 20 timed steps: finite falling loss and gradients, the
   readout moves, one ``fused_izh_fwd_train`` and one ``fused_izh_bwd``
   launch a step; the hidden weights Adam moved are counted, see
   ``izh_train_run``) and
   periodic (5 steps, times); then 784-128-128-10 (layer 0 + one scan call
   + the readout loop) the same way: one ``fused_izh_layer0_fwd/bwd`` and
   one ``izh_scan_fwd/bwd`` launch a step.  Each backward kernel against
   its plain version on the forward kernel's residuals with the trained
   weights (1e-4 of max|g| / 2**-7); each kernel alone on its phase's
   batch, timed, with its bound and its error on those inputs.

11. two-layer kernels -- ``fused2_fwd[_train]`` and ``fused2_bwd`` against
   their plain versions on phase 3b's grid (spikes, ``tstar`` and counts
   equal, logits 1e-5, gradients on the same residuals 2e-6 of max|g|, 5e-6
   at T = 100, 2**-7 bf16, equal bits on a repeated call) and against the
   composed kernels (``fused_layer0_fwd`` + ``fused_mid_fwd[head]``): logits,
   ``tstar``, both counts and both residuals bit for bit, small and at
   784-128-128-10, B = 8192 (there the gradients within 1e-4 of max|g| of
   ``fused_mid_bwd`` + ``fused_layer0_bwd``, 2**-6 bf16);
12. two-layer serve -- 784-ALIF128-ALIF128-10 (``bench.py``'s twolayer leg)
   served as in 4: one ``fused2_fwd`` launch a batch and no layer-0 or mid
   kernel, results bitwise a direct forward; on a 4096-row batch the pair
   equals the composed kernels bitwise, both timed;
13. two-layer train -- that network through ``Trainer`` at batch 8192, lr
   3e-5: 3 warm-up and 20 timed TTFS steps (finite falling loss, both betas bitwise,
   every trained leaf moves, one ``fused2_fwd_train`` and one ``fused2_bwd``
   launch a step), each kernel against its plain version on the trained
   weights (the backward on the forward's residuals), timed beside the
   composed kernels and a forward + backward through the composed public
   functions on the same batch; at lr 1e-3 the first step's gradients
   against the per-step loop's (1e-4 of max|g|) and both paths' losses; 5
   periodic steps (times), 3 with ``L2SpikesPerNeuron`` (launches);
14. wide kernels -- the unfused tier's ``encode_matmul_fwd/bwd`` and
   ``rec_scan_fwd[_train]/bwd`` against their plain versions: TTFS and
   periodic, LIF/ALIF x FastSigmoid/Phi (recurrent), T = 24 and 100, f32
   and bf16 at small shapes (spikes equal, currents 1e-5 of max|current|,
   residuals 1e-5 / 2**-7, gradients on the same residuals 2e-6 of max|g|,
   5e-6 at T = 100, 2**-7 bf16, equal bits twice), then B = 8192 at 784 ->
   512 and B = 256 at H = 1024 (spikes equal on >= 99.5 % of rows,
   gradients 1e-4 of max|g|);
15. wide serve -- 784-ALIF512-10 (recurrent, learn_beta, T = 100), whose
   W_rec no fused kernel holds, served as in 4: results bitwise a direct
   forward, one ``encode_matmul_fwd`` and one ``rec_scan_fwd`` launch a
   batch and no training kernel; on a served batch spikes equal the plain
   versions' on >= 99.5 % of rows and logits within 1e-4 of max|logit| on
   >= 99 %; each kernel alone timed beside its plain version (and cuBLAS on
   the materialised raster for the encoded product);
16. wide train -- that network through ``Trainer`` at batch 8192: the
   first step's gradients against the per-step loop's (1e-4 of max|g|,
   f32), 3 warm-up and 20 timed TTFS steps (finite falling loss, beta
   bitwise, every trained leaf moves, one launch a step of each of
   ``encode_matmul_fwd``, ``rec_scan_fwd_train``, ``rec_scan_bwd``,
   ``encode_matmul_bwd``), the logits of batch 0 against the plain
   versions' composition (the bars of 15), each kernel alone on the trained
   weights against its plain version, timed; 5 periodic steps (times,
   launches).
17. scan kernels -- the feedforward scan's ``scan_fwd[_train]`` and
   ``scan_bwd`` against their plain versions: LIF/ALIF x FastSigmoid/Phi,
   T = 23, 24 and 100, B = 37, H = 19 and 45 (beta a float, then a device
   tensor), f32 and bf16 (spikes equal, residuals 1e-5 / 2**-7, gradients
   on the same residuals bit for bit for FastSigmoid and 2e-6 of max|g| for
   Phi, equal bits twice), then B = 8192, T = 100 at H = 128, 256, 512 and
   1024 (spikes equal on >= 99.5 % of rows, the same gradient bars); layer 0
   of 784-ALIF256-10 through ``encode_matmul_fwd`` + ``scan_fwd`` against
   ``fused_layer0_fwd`` on the same weights (>= 99.5 % of rows equal, TTFS
   and periodic);
18. ff serve -- 784-ALIF256-10 and 784-LIF128-10 (feedforward, T = 100,
   ``scripts/run_baseline_configs.py`` configs #3 and #1) with
   constant-pixel input (``as_timeseries=False``) served as in 4: results
   bitwise a direct forward, one ``scan_fwd`` launch a batch and no other
   kernel; on a served batch the spikes and logits against the plain
   version's (the bars of 15); the kernel alone timed; for 784-LIF128-10
   also ``forward_logits`` on a TTFS raster (4096, 100, 784), one
   ``scan_fwd``;
19. ff train -- both through ``Trainer`` at batch 8192, lr 1e-3: the first
   step's gradients against the per-step loop's (1e-4 of max|g|, f32), 3
   warm-up and 20 timed steps (finite falling loss, every trained leaf
   moves, one ``scan_fwd_train`` and one ``scan_bwd`` launch a step), 3
   steps through the per-step loop timed beside them, each kernel alone on
   the trained weights against its plain version, timed; 784-ALIF256-10
   also 5 steps with its own periodic encoding (the route
   ``explain_dispatch`` names and its launches).

20. stacked kernels -- the stacked replica mode (an ensemble's seeds in one
   launch) of ``fused_head_fwd[_train]``, ``fused_head_bwd``,
   ``fused_izh_fwd[_train]`` and ``fused_izh_bwd``: 16 small LIF/ALIF cases
   (S = 3; recurrent / feedforward x TTFS / periodic x FastSigmoid / Phi,
   T = 23, 24, 100, f32 / bf16, beta a float or an (S,) tensor), 4
   Izhikevich ones at dt = 30, and the flagship at S = 6, B = 8192: every
   output and gradient bitwise equal to S single launches, the plain bars of
   the single kernels (``phase_stacked_kernels``);
21. ensemble serve -- six seeds of the flagship (periodic,
   ``scripts/ensemble_serve_bench.py``) through ``EnsembleTrainer.serve()``
   as in 4: one ``fused_head_fwd_stacked`` launch a batch, results within
   1e-6 of ``predict_proba``; the stacked kernel on a served batch within
   the flagship bars of its plain version, timed against six single
   launches;
22. ensemble train -- the six seeds at batch 8192 on phase 5's task
   (periodic), ``fused_replicas="stacked"`` against the default (unrolled): per-seed
   losses bitwise equal for 3 steps, one stacked forward and backward a
   step, losses fall, beta bitwise; ms a step and seed-img/s of both; each
   stacked kernel on the trained weights against its plain version (the
   backward within 1e-4 of max|g|, bf16 2**-7); then ``fit`` on
   ``get_dataloaders(DatasetId.MNIST)`` with checkpoints: a resume from
   LAST_EPOCH equals a continuous fit bitwise, ``load_best`` installs each
   seed's best epoch, every seed's training and validation losses fall
   over the 3 epochs, the ensemble beats chance;
23. Izhikevich ensemble -- 784-Izh128-10 at dt = 30, six seeds, served and
   trained as in 21 and 22 (3 steps stacked against unrolled bitwise);
   every replica's forward, served and trained, bitwise the plain cell
   summed in the kernel's order on 256 rows, the backward as in 22.

Phase 3 also holds the deep-network kernels (``fused_layer0_fwd/bwd``,
``fused_mid_fwd/bwd``) against their plain versions: LIF/ALIF x ff/rec x
FastSigmoid/Phi x {float32, bfloat16} at small shapes with T = 24 (TTFS and
periodic) and T = 100, and ALIF recurrent at the deep network's full width
with B = 8192 (``phase_deep_kernels``).

Then one JSON line describing every kernel (launches from its phase's
main run, times and bound on that run's inputs), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import snnimageclassification_tpu_torch as pt
from snnimageclassification_tpu_torch.data import DatasetId, get_dataloaders
from snnimageclassification_tpu_torch.models import snn as model_lib
from snnimageclassification_tpu_torch.ops import (
    _build,
    encode,
    fused,
    fused2,
    fused_izh,
    fused_mid,
    izh,
    rec_scan,
    scan,
)
from snnimageclassification_tpu_torch.ops.cells import (
    ALIFConfig,
    IzhikevichConfig,
    LIFConfig,
    ReadoutConfig,
    masked_recurrent,
)
from snnimageclassification_tpu_torch.ops.encoding import (
    pixels_to_firing_periods,
    spike_row,
)
from snnimageclassification_tpu_torch.ops.surrogate import SpikeFuncType
from snnimageclassification_tpu_torch.parallel import EnsembleTrainer
from snnimageclassification_tpu_torch.train import (
    L2SpikesPerNeuron,
    LoadCheckpointMode,
    Trainer,
    nll_loss,
)

H100_F32_FLOPS = 67e12      # float32 outside the tensor cores, SXM, 700 W
H100_BF16_FLOPS = 989e12    # bf16 dense tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``n`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: build every kernel source in parallel
# ---------------------------------------------------------------------------
SOURCES = _build.SOURCES


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
        log(f"[build] {name}: {_build.build_log.get(name, '(cached)').strip()}")
    log(f"[build] seconds={time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain version
# ---------------------------------------------------------------------------
HEAD_CASES = [  # name, alif, recurrent, use_periods
    ("alif-rec-ttfs", True, True, False),
    ("alif-rec-periodic", True, True, True),
    ("alif-ff-ttfs", True, False, False),
    ("lif-rec-periodic", False, True, True),
]


def head_args(rng, B, F, H, O, T, alif, rec, use_periods, wdtype, flagship,
              spike_func=SpikeFuncType.FastSigmoid):
    """Latencies (tau=20, so spike times spread over the window) and
    weights at the init scale of the flagship, or the JAX tests' scale."""
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=20.0)
    s_in, s_rec = (cfg.threshold, cfg.threshold) if flagship else (0.5, 0.3)

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).cuda()

    w_in = w((F, H), s_in).to(wdtype)
    w_rec = ((w((H, H), s_rec) * (1 - torch.eye(H, device="cuda")))
             .to(wdtype) if rec else None)
    w_out = w((H, O), 1.0).to(wdtype)
    b_out = w((O,), 0.1)
    return dict(latencies=lat.contiguous(), w_in=w_in, w_rec=w_rec,
                beta=1.6 if alif else 0.0, w_out=w_out, b_out=b_out,
                n_steps=T, use_periods=use_periods, alif=alif,
                alpha=cfg.alpha, rho=cfg.rho if alif else 0.0,
                threshold=cfg.threshold, gamma=cfg.gamma, kappa=kappa,
                spike_func=spike_func)


def run_head(args, plain: bool):
    a = dict(args)
    w_rec = a.pop("w_rec")
    if w_rec is None:
        fn = (fused.fused_encode_ff_scan_head_reference if plain
              else fused.fused_encode_ff_scan_head)
        return fn(**a)
    fn = (fused.fused_encode_rec_scan_head_reference if plain
          else fused.fused_encode_rec_scan_head)
    return fn(w_rec=w_rec, **a)


def compare_flagship(got, ref):
    """(argmax agreement, share of rows within 1e-4 max|logit|, max err)."""
    scale = float(ref.abs().max())
    row_err = (got - ref).abs().amax(dim=1)
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    close = float((row_err <= 1e-4 * scale).float().mean())
    return agree, close, float(row_err.max()), scale


def phase_kernels() -> None:
    rng = np.random.default_rng(0)
    for wname, wdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, alif, rec, per in HEAD_CASES:
            for T in (12, 24):
                args = head_args(rng, 37, 30, 20, 10, T, alif, rec, per,
                                 wdtype, flagship=False)
                got, ref = run_head(args, False), run_head(args, True)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not torch.allclose(got, ref, atol=1e-5, rtol=1e-5):
                    fail(f"small {name} {wname} T={T}: max err {err:.3g}")
                log(f"[kernels] small {name} {wname} T={T}: max_abs_err="
                    f"{err:.3g} ok")
            args = head_args(rng, 4096, 784, 128, 10, 100, alif, rec, per,
                             wdtype, flagship=True)
            got, ref = run_head(args, False), run_head(args, True)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"flagship {name} {wname}: non-finite logits")
            agree, close, err, scale = compare_flagship(got, ref)
            n = got.shape[0]
            ms = cuda_ms(lambda: run_head(args, False), 10)
            log(f"[kernels] flagship {name} {wname}: argmax_agree="
                f"{round(agree * n)}/{n} rows_within_1e-4max={round(close * n)}"
                f"/{n} max_abs_err={err:.3g} max|logit|={scale:.3g} "
                f"kernel_ms={ms:.4f}")
            if agree < 0.995 or close < 0.99:
                fail(f"flagship {name} {wname}: agreement below the bar")


PHI = SpikeFuncType.Phi
TRAIN_CASES = [(*c, SpikeFuncType.FastSigmoid, False) for c in HEAD_CASES] + [
    # name, alif, recurrent, use_periods, surrogate, counts
    ("alif-rec-phi", True, True, False, PHI, False),  # two residuals
    ("alif-rec-ttfs-counts", True, True, False, SpikeFuncType.FastSigmoid,
     True),
]


def train_forward(args, counts: bool, plain: bool):
    """The training forward (kernel or plain) on ``head_args``:
    (logits, delta, a, tstar, counts)."""
    k = args
    fn = fused._head_train_reference if plain else fused._head_train_cuda
    return fn(k["latencies"], k["w_in"], k["w_rec"], k["beta"], k["w_out"],
              k["b_out"], k["n_steps"], k["use_periods"], k["alif"],
              k["alpha"], k["rho"], k["threshold"], k["kappa"], True,
              k["alif"] and k["spike_func"] == PHI, counts)


def backward(args, g_logits, g_counts, res, plain: bool):
    """The backward (kernel or plain) fed the residuals ``res`` of one
    training forward: (g_w_in, g_w_rec, g_w_out, g_b)."""
    k = args
    _, delta, a_tr, tstar, _ = res
    fn = fused._head_bwd_reference if plain else fused._head_bwd_cuda
    return fn(g_logits, g_counts, tstar, delta, a_tr, k["latencies"],
              k["w_in"], k["w_rec"], k["beta"], k["w_out"], k["n_steps"],
              k["use_periods"], k["alpha"], k["threshold"], k["gamma"],
              k["kappa"], k["spike_func"])


def grad_error(got, want):
    """Largest |got - want| / max|want| over the gradients."""
    worst = 0.0
    for g, p in zip(got, want):
        if p is None:
            if g is not None:
                fail("a gradient for weights that are not there")
            continue
        scale = float(p.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - p.float()).abs().max()) / scale)
    return worst


def check_backward(label, args, res, g_logits, g_counts, bar):
    """K2 against its plain version on the same residuals and tstar (so no
    spike flip stands between them), and K2 twice for equal bits."""
    got = backward(args, g_logits, g_counts, res, plain=False)
    again = backward(args, g_logits, g_counts, res, plain=False)
    want = backward(args, g_logits, g_counts, res, plain=True)
    torch.cuda.synchronize()
    for g, g2 in zip(got, again):
        if g is not None and not torch.equal(g, g2):
            fail(f"{label}: the backward is not reproducible bit for bit")
        if g is not None and not bool(torch.isfinite(g.float()).all()):
            fail(f"{label}: non-finite gradient")
    err = grad_error(got, want)
    if err > bar:
        fail(f"{label}: gradient error {err:.3g} of max|g| above {bar:.3g}")
    return err


def phase_train_kernels() -> None:
    """``fused_head_fwd_train`` (K1) and ``fused_head_bwd`` (K2) against
    their plain versions.

    K1: logits bitwise equal to ``fused_head_fwd``'s (same arithmetic,
    same order).  Small shapes: ``tstar`` and counts equal the plain
    version's, residuals within 1e-5 (float32: another summation order) or
    2**-7 relative (bfloat16: one rounding of the stored value).  Flagship
    shape, B=8192: the forward kernel's row bars (a reordered float32 sum
    can flip a near-tie spike, which cascades through that row), and
    ``tstar`` equal on the rows whose logits agree.
    K2: each gradient scaled by its max|g|.  Small shapes: 2e-6 (a few
    hundred float32 terms in another order).  Flagship shape: 1e-4, where
    819,200 terms are summed in another order.  bfloat16 weights: 2**-7
    at both, one rounding of the result."""
    rng = np.random.default_rng(2)
    for wname, wdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        f32 = wdtype == torch.float32
        for name, alif, rec, per, spike, counts in TRAIN_CASES:
            for T in (12, 24):
                args = head_args(rng, 37, 30, 20, 10, T, alif, rec, per,
                                 wdtype, False, spike)
                res = train_forward(args, True, plain=False)
                ref = train_forward(args, True, plain=True)
                if not torch.equal(res[0], run_head(args, False)):
                    fail(f"small {name} {wname}: K1 logits differ from "
                         "fused_head_fwd's")
                if not (torch.equal(res[3], ref[3])
                        and torch.equal(res[4], ref[4])):
                    fail(f"small {name} {wname} T={T}: tstar or counts")
                tol = 1e-5 if f32 else 2.0 ** -7
                for got, want in zip(res[1:3], ref[1:3]):
                    if (got is None) != (want is None):
                        fail(f"small {name} {wname}: residual set differs")
                    if got is not None and not torch.allclose(
                            got.float(), want.float(), atol=tol, rtol=tol):
                        fail(f"small {name} {wname} T={T}: residuals differ")
                g_logits = torch.from_numpy(rng.standard_normal(
                    (37, 10)).astype(np.float32)).cuda()
                g_counts = torch.from_numpy((0.01 * rng.standard_normal(
                    (37, 20))).astype(np.float32)).cuda() if counts else None
                err = check_backward(f"small {name} {wname} T={T}", args, res,
                                     g_logits, g_counts,
                                     2e-6 if f32 else 2.0 ** -7)
                log(f"[train-kernels] small {name} {wname} T={T}: K1 ok, "
                    f"K2 grad_err={err:.3g} ok")
            B = 8192
            args = head_args(rng, B, 784, 128, 10, 100, alif, rec, per,
                             wdtype, True, spike)
            res = train_forward(args, counts, plain=False)
            ref = train_forward(args, counts, plain=True)
            if not torch.equal(res[0], run_head(args, False)):
                fail(f"flagship {name} {wname}: K1 logits differ from "
                     "fused_head_fwd's")
            agree, close, err, scale = compare_flagship(res[0], ref[0])
            same_row = (res[0] - ref[0]).abs().amax(1) <= 1e-4 * scale
            if agree < 0.995 or close < 0.99:
                fail(f"flagship {name} {wname}: K1 agreement below the bar")
            if not torch.equal(res[3][same_row], ref[3][same_row]):
                fail(f"flagship {name} {wname}: tstar differs on rows whose "
                     "logits agree")
            del ref
            g_logits = torch.from_numpy(rng.standard_normal(
                (B, 10)).astype(np.float32)).cuda() / B
            g_counts = torch.from_numpy((1e-3 * rng.standard_normal(
                (B, 128))).astype(np.float32)).cuda() / B if counts else None
            gerr = check_backward(f"flagship {name} {wname}", args, res,
                                  g_logits, g_counts,
                                  1e-4 if f32 else 2.0 ** -7)
            log(f"[train-kernels] flagship {name} {wname} B={B}: K1 "
                f"argmax_agree={round(agree * B)}/{B} rows_within_1e-4max="
                f"{round(close * B)}/{B} max_abs_err={err:.3g}; K2 "
                f"grad_err={gerr:.3g} of max|g|, reproducible")
            del res, args
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3b: the deep-network kernels against their plain versions
# ---------------------------------------------------------------------------
FS = SpikeFuncType.FastSigmoid
DEEP_CASES = [  # name, alif, recurrent, surrogate
    (f"{'alif' if alif else 'lif'}-{'rec' if rec else 'ff'}-"
     f"{'fs' if spike == FS else 'phi'}", alif, rec, spike)
    for alif in (True, False) for rec in (True, False)
    for spike in (FS, PHI)
]


def rand_w(rng, shape, std, wdtype=torch.float32):
    return torch.from_numpy(
        (std * rng.standard_normal(shape)).astype(np.float32)).cuda().to(wdtype)


def deep_layer(rng, n_in, n, rec, std_in, std_rec, wdtype):
    """(w_in, masked w_rec | None) of one hidden layer."""
    w_rec = ((rand_w(rng, (n, n), std_rec)
              * (1 - torch.eye(n, device="cuda"))).to(wdtype) if rec else None)
    return rand_w(rng, (n_in, n), std_in, wdtype), w_rec


def rows_equal(a, b):
    """Share of batch rows of two (T, B, H) traces that are equal
    everywhere."""
    return float((a == b).all(dim=2).all(dim=0).float().mean())


def trace_close(label, got, want, f32):
    """Residual traces: 1e-5 (float32: another summation order) or 2**-7
    relative (bfloat16: one rounding of the stored value)."""
    tol = 1e-5 if f32 else 2.0 ** -7
    if (got is None) != (want is None):
        fail(f"{label}: residual set differs")
    if got is not None and not torch.allclose(got.float(), want.float(),
                                              atol=tol, rtol=tol):
        fail(f"{label}: residuals differ by "
             f"{float((got.float() - want.float()).abs().max()):.3g}")


def check_grads(label, fn, plain_fn, bar):
    """A backward kernel against its plain version on the same residuals
    and cotangents, and twice for equal bits; returns the largest error of
    max|g|."""
    got, again, want = fn(), fn(), plain_fn()
    torch.cuda.synchronize()
    for g, g2 in zip(got, again):
        if g is not None and not torch.equal(g, g2):
            fail(f"{label}: the backward is not reproducible bit for bit")
        if g is not None and not bool(torch.isfinite(g.float()).all()):
            fail(f"{label}: non-finite gradient")
    err = grad_error(got, want)
    if err > bar:
        fail(f"{label}: gradient error {err:.3g} of max|g| above {bar:.3g}")
    return err


def layer_scalars(alif):
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=1, output_size=1)
    return cfg.alpha, (cfg.rho if alif else 0.0), cfg.threshold, cfg.gamma


def check_deep_stack(label, rng, B, F, widths, O, T, alif, rec, spike, per,
                     wdtype, flagship, bar_small):
    """Layer 0 -> mid layers -> mid head at one shape: every forward kernel
    against its plain version fed the same input (the kernel's own trace
    from the layer before, so no spike flip of an earlier layer stands
    between them), and every backward kernel against its plain version on
    the forward kernel's residuals.  Returns the lowest share of rows with
    equal spikes, the worst logit and gradient error."""
    f32 = wdtype == torch.float32
    alpha, rho, thr, gamma = layer_scalars(alif)
    kappa = ReadoutConfig(input_size=1, output_size=1).kappa
    beta = 1.6 if alif else 0.0
    store_a = alif and spike == PHI
    res_is_v = fused._residual_is_v(alif, spike)
    s_in, s_rec = (thr, thr) if flagship else (0.5, 0.3)
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    w0, wr0 = deep_layer(rng, F, widths[0], rec, s_in, s_rec, wdtype)
    sc0 = (T, per, alif, alpha, rho, thr)
    worst_rows, worst_grad = 1.0, 0.0
    gbar = 2.0 ** -7 if not f32 else (1e-4 if flagship else bar_small)

    # Layer 0.
    z, res, a_tr = fused._layer0_cuda(lat, w0, wr0, beta, *sc0, True,
                                      store_a, res_is_v)
    z_inf = fused._layer0_cuda(lat, w0, wr0, beta, *sc0, False, False,
                               False)[0]
    zp, resp, ap = fused._layer0_reference(lat, w0, wr0, beta, *sc0, True,
                                           store_a, res_is_v)
    if not torch.equal(z, z_inf):
        fail(f"{label}: layer-0 inference and training spikes differ")
    w_out0 = rand_w(rng, (widths[0], O), 1.0, wdtype)
    b0 = rand_w(rng, (O,), 0.1)
    delta_head = fused._head_train_cuda(
        lat, w0, wr0, beta, w_out0, b0, *sc0, kappa, True, False, False)[1]
    if not torch.equal(z, (delta_head.float() >= 0).to(wdtype)):
        fail(f"{label}: layer-0 spikes differ from the head kernel's")
    share = rows_equal(z, zp)
    worst_rows = min(worst_rows, share)
    if not flagship:
        if share < 1.0:
            fail(f"{label}: layer-0 spikes differ from the plain version's")
        trace_close(f"{label} layer 0", res, resp, f32)
        trace_close(f"{label} layer 0 a", a_tr, ap, f32)
    g_z = rand_w(rng, tuple(z.shape), 1.0 / B, wdtype)
    bw = (lat, w0, wr0, beta, T, per, alpha, thr, gamma, spike)
    worst_grad = max(worst_grad, check_grads(
        f"{label} layer-0 backward",
        lambda: fused._layer0_bwd_cuda(g_z, z, res, a_tr, res_is_v, *bw),
        lambda: fused._layer0_bwd_reference(g_z, z, res, a_tr, res_is_v,
                                            *bw), gbar))
    del res, a_tr, zp, resp, ap, delta_head, z_inf, g_z

    # Mid layers, then the mid head, each fed the kernel's trace.
    z_in = z
    for n_in, n in zip(widths[:-2], widths[1:-1]):
        w1, wr1 = deep_layer(rng, n_in, n, rec, s_in, s_rec, wdtype)
        sc = (T, alif, alpha, rho, thr, 0.0)
        out = fused_mid._mid_cuda(z_in, w1, wr1, beta, None, None, *sc, True,
                                  store_a, False, res_is_v)
        inf = fused_mid._mid_cuda(z_in, w1, wr1, beta, None, None, *sc,
                                  False, False, False, False)
        ref = fused_mid._mid_reference(z_in, w1, wr1, beta, None, None, *sc,
                                       True, store_a, False, res_is_v)
        if not torch.equal(out[1], inf[1]):
            fail(f"{label}: mid inference and training spikes differ")
        share = rows_equal(out[1], ref[1])
        worst_rows = min(worst_rows, share)
        if not flagship:
            if share < 1.0:
                fail(f"{label}: mid spikes differ from the plain version's")
            trace_close(f"{label} mid", out[2], ref[2], f32)
            trace_close(f"{label} mid a", out[3], ref[3], f32)
        g_z = rand_w(rng, tuple(out[1].shape), 1.0 / B, wdtype)
        bw = (res_is_v, z_in, w1, wr1, beta, None, T, alpha, thr, gamma, 0.0,
              spike)
        worst_grad = max(worst_grad, check_grads(
            f"{label} mid backward",
            lambda: fused_mid._mid_bwd_cuda(None, None, None, g_z, out[1],
                                            out[2], out[3], *bw),
            lambda: fused_mid._mid_bwd_reference(None, None, None, g_z,
                                                 out[1], out[2], out[3],
                                                 *bw), gbar))
        z_in = out[1]
        del out, inf, ref, g_z

    n_in, n = widths[-2], widths[-1]
    wh, wrh = deep_layer(rng, n_in, n, rec, s_in, s_rec, wdtype)
    w_out = rand_w(rng, (n, O), 1.0, wdtype)
    b_out = rand_w(rng, (O,), 0.1)
    sc = (T, alif, alpha, rho, thr, kappa)
    out = fused_mid._mid_cuda(z_in, wh, wrh, beta, w_out, b_out, *sc, True,
                              store_a, True, False)
    inf = fused_mid._mid_cuda(z_in, wh, wrh, beta, w_out, b_out, *sc, False,
                              False, False, False)
    ref = fused_mid._mid_reference(z_in, wh, wrh, beta, w_out, b_out, *sc,
                                   True, store_a, True, False)
    torch.cuda.synchronize()
    if not torch.equal(out[0], inf[0]):
        fail(f"{label}: mid-head inference and training logits differ")
    agree, close, err, scale = compare_flagship(out[0], ref[0])
    if flagship:
        if agree < 0.995 or close < 0.99:
            fail(f"{label}: mid-head agreement below the bar "
                 f"({agree:.4f}, {close:.4f})")
        same = (out[0] - ref[0]).abs().amax(1) <= 1e-4 * scale
        if not torch.equal(out[4][same], ref[4][same]):
            fail(f"{label}: mid-head tstar differs on rows whose logits "
                 "agree")
    else:
        if not torch.allclose(out[0], ref[0], atol=1e-5, rtol=1e-5):
            fail(f"{label}: mid-head logits differ by {err:.3g}")
        if not (torch.equal(out[4], ref[4]) and torch.equal(out[5], ref[5])):
            fail(f"{label}: mid-head tstar or counts differ")
        trace_close(f"{label} mid head", out[2], ref[2], f32)
        trace_close(f"{label} mid head a", out[3], ref[3], f32)
    g_logits = rand_w(rng, (B, O), 1.0 / B)
    g_counts = rand_w(rng, (B, n), 1e-3 / B)
    bw = (False, z_in, wh, wrh, beta, w_out, T, alpha, thr, gamma, kappa,
          spike)
    worst_grad = max(worst_grad, check_grads(
        f"{label} mid-head backward",
        lambda: fused_mid._mid_bwd_cuda(g_logits, g_counts, out[4], None,
                                        None, out[2], out[3], *bw),
        lambda: fused_mid._mid_bwd_reference(g_logits, g_counts, out[4],
                                             None, None, out[2], out[3],
                                             *bw), gbar))
    return worst_rows, agree, close, err, worst_grad


DEEP_WIDTHS = (128, 128, 96)


def phase_deep_kernels() -> None:
    """``fused_layer0_fwd/bwd`` and ``fused_mid_fwd/bwd`` against their
    plain versions.  Small shapes (T = 24 and 100): spikes, ``tstar`` and
    counts equal, logits to 1e-5, residuals to 1e-5 (float32) or 2**-7
    (bfloat16), gradients to 2e-6 of max|g| (float32; T = 100 sums four
    times the terms: 5e-6) or 2**-7 (bfloat16).  Full width
    (784-128-128-96-10, B = 8192, T = 100): per layer the share of rows with
    equal spikes is printed, the mid head holds the head kernel's row bars,
    gradients 1e-4 / 2**-7."""
    rng = np.random.default_rng(4)
    for wname, wdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, alif, rec, spike in DEEP_CASES:
            for T, per in ((24, False), (24, True), (100, False)):
                label = (f"deep small {name} {wname} T={T} "
                         f"{'periodic' if per else 'ttfs'}")
                rows, _, _, err, gerr = check_deep_stack(
                    label, rng, 37, 30, (20, 24, 18), 10, T, alif, rec,
                    spike, per, wdtype, False, 2e-6 if T < 100 else 5e-6)
                log(f"[deep-kernels] {label}: spikes equal, logits err="
                    f"{err:.3g}, grad_err={gerr:.3g} ok")
        for per in (False, True):
            label = (f"deep full alif-rec-fs {wname} "
                     f"{'periodic' if per else 'ttfs'}")
            rows, agree, close, err, gerr = check_deep_stack(
                label, rng, TRAIN_B, 784, DEEP_WIDTHS, 10, 100, True, True,
                FS, per, wdtype, True, 0.0)
            log(f"[deep-kernels] {label} B={TRAIN_B}: lowest share of rows "
                f"with equal spikes={rows:.5f}; mid head argmax_agree="
                f"{agree:.5f} rows_within_1e-4max={close:.5f} max_abs_err="
                f"{err:.3g}; grad_err={gerr:.3g} of max|g|, reproducible")
            if rows < 0.995:
                fail(f"{label}: spikes equal on {rows:.5f} of rows only")
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the main path through InferenceServer
# ---------------------------------------------------------------------------
N_THREADS, PER_THREAD, ROWS = 4, 4, 512


def flagship_cfg(matmul_dtype):
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=128,
        hidden_layer_type=pt.LayerType.ALIF, use_recurrent_connection=True,
        learn_beta=True, int_time_steps=100, matmul_dtype=matmul_dtype,
    )


def input_spike_count(lat, T, use_periods=False):
    return sum(int(spike_row(lat, t, T, use_periods).sum()) for t in range(T))


def head_work(lat, T, H, O, recurrent, hidden_spikes, itemsize,
              use_periods=False):
    """(bytes, operations) the inference head needs on these inputs: each
    input read once and the logits written once; one add per selected
    weight of the 0/1 products (input spikes x H, hidden spikes x (H + O))
    plus ~10 float32 operations per (row, step, unit) of the dynamics and
    3 per (row, step, output) of the readout."""
    B, F = lat.shape
    in_spikes = input_spike_count(lat, T, use_periods)
    weights = (F * H + (H * H if recurrent else 0) + H * O) * itemsize
    nbytes = lat.numel() * 4 + weights + O * 4 + 4 + B * O * 4
    ops = (in_spikes * H + hidden_spikes * ((H if recurrent else 0) + O)
           + 10 * B * T * H + 3 * B * T * O)
    return nbytes, ops, in_spikes


def hidden_spike_count(args):
    """Hidden spikes of the whole run: the training forward's counts."""
    a = dict(args)
    w_rec = a.pop("w_rec")
    with torch.no_grad():
        _, counts = fused.fused_encode_rec_scan_head_counts(w_rec=w_rec, **a)
    return int(counts.sum())


def flagship_head_args(cfg, params, lat, use_periods=False):
    """The head call's arguments as ``forward_logits_pixels`` builds them."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    p0, ro = params["input"], params["readout"]
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    return dict(
        latencies=lat, w_in=p0["w_in"].detach().to(md).contiguous(),
        w_rec=masked_recurrent(lcfg, p0).detach().to(md).contiguous(),
        beta=p0["beta"].detach(),
        w_out=ro["w_in"].detach().to(md).contiguous(),
        b_out=ro["b"].detach().contiguous(), n_steps=cfg.int_time_steps,
        use_periods=use_periods, alif=True, alpha=lcfg.alpha, rho=lcfg.rho,
        threshold=lcfg.threshold, gamma=lcfg.gamma, kappa=rcfg.kappa,
        spike_func=lcfg.spike_func)


def serve_requests(label, cfg, params, enc, want_launches, server=None,
                   direct=None, atol=0.0):
    """Serve 16 requests of 512 uint8 rows from 4 threads through
    ``InferenceServer`` at batch 4096 (or the server ``server(**kwargs)``
    makes); every result must equal a direct forward on the card bitwise
    (same kernels, same per-row arithmetic; ``direct(x)`` in place of
    ``forward_logits_pixels``, within ``atol``), and each kernel of
    ``want_launches`` must have been launched that many times a batch, no
    other kernel at all.  Returns (requests, launches)."""
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, 256, size=(ROWS, 784), dtype=np.uint8)
            for _ in range(N_THREADS * PER_THREAD)]
    results = [None] * len(reqs)
    kwargs = dict(batch_size=4096, max_delay_s=0.05, encode_config=enc,
                  input_dtype=np.uint8)
    if server is None:
        srv_cm = pt.InferenceServer(cfg, params, device="cuda", **kwargs)
    else:
        srv_cm = server(**kwargs)
    with srv_cm as srv:
        srv.submit(reqs[0]).result(timeout=120)  # warm: allocator, streams
        warm_batches = srv.stats.batches

        def worker(k):
            mine = [(i, srv.submit(reqs[i]))
                    for i in range(k, len(reqs), N_THREADS)]
            for i, fut in mine:
                results[i] = fut.result(timeout=120)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(N_THREADS)]
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = fused.launch_counts()
        if any(t.is_alive() for t in threads):
            fail(f"{label}: requests did not finish")
        snap = srv.stats.snapshot()
    batches = snap["batches"] - warm_batches
    log(f"[{label}] stats={json.dumps(snap)}")
    log(f"[{label}] served {len(reqs) * ROWS} rows in {wall:.4f} s = "
        f"{len(reqs) * ROWS / wall:.1f} img/s over {batches} batches; "
        f"launches={json.dumps(launched(launches))} [{card_line()}]")
    if batches < 1:
        fail(f"{label}: no batch was served")
    want = {k: n * batches for k, n in want_launches.items()}
    if launched(launches) != want:
        fail(f"{label}: launches {launched(launches)} for {batches} "
             f"batches, expected {want}")
    worst = 0.0
    for req, got in zip(reqs, results):
        x = torch.from_numpy(req).cuda().to(torch.float32) / 255.0
        want_l = (direct(x) if direct is not None
                  else model_lib.forward_logits_pixels(
                      cfg, params, x, enc, device="cuda")).cpu().numpy()
        if got.shape != (ROWS, 10) or not np.isfinite(got).all():
            fail(f"{label}: bad result {got.shape}")
        err = float(np.abs(got - want_l).max())
        worst = max(worst, err)
        if err > atol:
            fail(f"{label}: result differs from the direct forward by "
                 f"{err:.3g} (bar {atol:.3g})")
    log(f"[{label}]: {len(reqs)} results equal the direct forward "
        + ("bitwise" if atol == 0.0 else f"within {worst:.3g} (bar {atol})"))
    return reqs, launches


def launched(counts: dict) -> dict:
    """The kernels of a launch-count snapshot that were launched at all."""
    return {k: n for k, n in counts.items() if n}


def phase_serve(matmul_dtype: str) -> dict:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    cfg = flagship_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    path = model_lib.explain_dispatch(cfg, enc, device="cuda")[0]["path"]
    if path != f"cuda:{fused.KERNEL}":
        fail(f"serve {tag}: dispatch is {path}, not the head kernel")
    reqs, counts = serve_requests(f"serve {tag}", cfg, params, enc,
                                  {fused.KERNEL: 1})
    launches = counts[fused.KERNEL]

    # The kernel alone on a 4096-row batch of these inputs.
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    md = getattr(torch, matmul_dtype)
    args = flagship_head_args(cfg, params, lat)
    got, ref = run_head(args, False), run_head(args, True)
    torch.cuda.synchronize()
    agree, close, err, scale = compare_flagship(got, ref)
    log(f"[serve] {tag} kernel vs plain on the served batch: argmax_agree="
        f"{agree:.4f} rows_within_1e-4max={close:.4f} max_abs_err={err:.3g}")
    if agree < 0.995 or close < 0.99:
        fail(f"serve {tag}: kernel disagrees with its plain version")
    ms = cuda_ms(lambda: run_head(args, False), 25)
    plain_ms = cuda_ms(lambda: run_head(args, True), 5, warmup=1)
    hidden = hidden_spike_count(args)
    nbytes, ops, in_spikes = head_work(lat, 100, 128, 10, True, hidden,
                                       md.itemsize)
    log(f"[serve] {tag} input spikes={in_spikes} ({in_spikes / lat.numel():.4f}"
        f" of features), hidden spikes={hidden} "
        f"({hidden / (lat.shape[0] * 100 * 128):.4f} of unit-steps)")
    peak = H100_F32_FLOPS if md == torch.float32 else H100_BF16_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
    dense = 2 * 4096 * 100 * (784 * 128 + 128 * 128 + 128 * 10)
    log(f"[serve] {tag} {fused.KERNEL} per 4096-row batch: {ms:.4f} ms "
        f"(median of 25), plain {plain_ms:.4f} ms; bytes={nbytes} "
        f"ops={ops} -> bound {max(t_bytes, t_ops):.5f} ms; dense count "
        f"{dense} FLOP = {dense / peak * 1e3:.4f} ms [{card_line()}]")
    return {
        "name": f"{fused.KERNEL}[{tag}]",
        "route": "cuda",
        "source": "snnimageclassification_tpu_torch/csrc/fused_head.cu",
        "replaces": "snnimageclassification_tpu/ops/pallas_fused.py:703",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Phase 5: the training path through Trainer
# ---------------------------------------------------------------------------
TRAIN_B, WARMUP, TIMED = 8192, 3, 30


def synthetic_task(n_batches: int, seed: int = 3):
    """A learnable task: 10 class prototypes plus noise, clipped to [0, 1];
    ``n_batches`` batches of TRAIN_B rows on the card."""
    rng = np.random.default_rng(seed)
    protos = rng.random((10, 784), dtype=np.float32)
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, 10, TRAIN_B)
        x = np.clip(protos[y] + 0.15 * rng.standard_normal(
            (TRAIN_B, 784), dtype=np.float32), 0.0, 1.0)
        out.append((torch.from_numpy(x).cuda(),
                    torch.from_numpy(y).cuda()))
    return out


def timed_steps(trainer, batches, n, start=0):
    """(losses, seconds) of ``n`` training steps over ``batches`` in turn
    from batch ``start``, the clock read after a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(*batches[(start + i) % len(batches)])
              for i in range(n)]
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def train_kernel_rows(tag, args, md, launches, k1_err, k2_err, label):
    """Time K1 and K2 alone on one training batch and build their rows of
    the kernels line.  The bound counts each input read once and each
    output written once; the sparse products count what this batch fires."""
    B, F = args["latencies"].shape
    T, (H, O) = args["n_steps"], args["w_out"].shape
    itemsize = md.itemsize
    res = train_forward(args, False, plain=False)
    g_logits = torch.full((B, O), 1.0 / B, device="cuda")
    k1_ms = cuda_ms(lambda: train_forward(args, False, plain=False), 10)
    k2_ms = cuda_ms(lambda: backward(args, g_logits, None, res, False), 10)
    k1_plain = cuda_ms(lambda: train_forward(args, False, plain=True), 3, 1)
    k2_plain = cuda_ms(lambda: backward(args, g_logits, None, res, True),
                       3, 1)
    hidden = hidden_spike_count(args)
    in_spikes = input_spike_count(args["latencies"], T, args["use_periods"])
    weights = (F * H + H * H + H * O) * itemsize
    trace = T * B * H * itemsize
    lat_b = B * F * 4
    k1_bytes = lat_b + weights + O * 4 + 4 + 2 * B * O * 4 + trace
    k1_ops = (in_spikes * H + hidden * (H + O) + 10 * B * T * H
              + 3 * B * T * O)
    # K2: dcur @ W_rec^T and s @ W_out^T are dense (2 FLOP a term); the
    # three 0/1 products add one selected row a spike; ~12 float32
    # operations per (row, step, unit) of the chain.
    k2_bytes = trace + lat_b + 2 * B * O * 4 + 2 * weights + O * 4
    k2_ops = (2 * B * T * H * (H + O) + in_spikes * H + hidden * (H + O)
              + 12 * B * T * H)
    # What K2 really moves besides: its dcur buffer, written once by the
    # chain function and read by the g_W_in function (once per chunk of
    # 128 features, the repeats mostly from L2) and by the g_W_rec function.
    k2_moved = k2_bytes + 3 * trace
    peak = H100_F32_FLOPS if md == torch.float32 else H100_BF16_FLOPS
    dense1 = 2 * B * T * (F * H + H * H + H * O)
    dense2 = 2 * B * T * (F * H + 2 * H * H + 2 * H * O)
    rows = []
    for name, src, site, ms, plain_ms, nbytes, ops, err, dense in (
            (fused.KERNEL_TRAIN, "fused_head.cu", 703, k1_ms, k1_plain,
             k1_bytes, k1_ops, k1_err, dense1),
            (fused.KERNEL_BWD, "fused_head_bwd.cu", 1092, k2_ms, k2_plain,
             k2_bytes, k2_ops, k2_err, dense2)):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
        log(f"[train] {tag} {label} {name} per {B}-row batch: {ms:.4f} ms "
            f"(median of 10), plain {plain_ms:.4f} ms; bytes={nbytes} "
            f"ops={ops} -> bound {max(t_bytes, t_ops):.5f} ms; dense count "
            f"{dense} FLOP = {dense / peak * 1e3:.4f} ms [{card_line()}]")
        rows.append({
            "name": f"{name}[{tag}]", "route": "cuda",
            "source": f"snnimageclassification_tpu_torch/csrc/{src}",
            "replaces": f"snnimageclassification_tpu/ops/pallas_fused.py:"
                        f"{site}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    log(f"[train] {tag} {label} input spikes={in_spikes} hidden spikes="
        f"{hidden} ({hidden / (B * T * H):.4f} of unit-steps); K2 moves "
        f"{k2_moved} bytes with its dcur buffer = "
        f"{k2_moved / H100_BYTES_PER_S * 1e3:.4f} ms at the memory rate")
    return rows


def phase_train(matmul_dtype: str) -> list:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    md = getattr(torch, matmul_dtype)
    cfg = flagship_cfg(matmul_dtype)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    path = model_lib.explain_dispatch(cfg, enc, device="cuda",
                                      training=True)[0]["path"]
    if path != f"cuda:{fused.KERNEL_TRAIN}+{fused.KERNEL_BWD}":
        fail(f"train {tag}: dispatch is {path}, not the kernel pair")
    trainer = Trainer(cfg, seed=0, lr=1e-3, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    batches = synthetic_task(4)

    # The first step's gradients: K2 against the plain backward, both fed
    # K1's residuals and the loss's cotangent (bars as in phase 3), and
    # the whole step against the whole plain step (printed, not gated: a
    # flipped near-tie spike in one row moves it).
    x, y = batches[0]
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    args = flagship_head_args(cfg, trainer.params, lat)
    res = train_forward(args, False, plain=False)
    logits = res[0].clone().requires_grad_(True)
    (g_logits,) = torch.autograd.grad(nll_loss(logits, y), logits)
    k2_err = check_backward(f"train {tag} first step", args, res,
                            g_logits.contiguous(), None,
                            1e-4 if md == torch.float32 else 2.0 ** -7)
    ref = train_forward(args, False, plain=True)
    agree, close, k1_err, _ = compare_flagship(res[0], ref[0])
    if agree < 0.995 or close < 0.99:
        fail(f"train {tag}: K1 disagrees with its plain version")
    _, grads = trainer.loss_and_grads(x, y)
    plain_leaves = {n: {k: v.detach().clone().requires_grad_(k != "beta")
                        for k, v in g.items()}
                    for n, g in trainer.params.items()}
    (_, lcfg), _ = cfg.layer_configs
    pa = flagship_head_args(cfg, trainer.params, lat)
    pa.update(
        w_in=plain_leaves["input"]["w_in"].to(md).contiguous(),
        w_rec=masked_recurrent(lcfg, plain_leaves["input"]).to(md)
        .contiguous(),
        w_out=plain_leaves["readout"]["w_in"].to(md).contiguous(),
        b_out=plain_leaves["readout"]["b"].contiguous())
    nll_loss(run_head(pa, plain=True), y).backward()
    whole = grad_error(
        [grads[n][k] for n in grads for k in grads[n]],
        [plain_leaves[n][k].grad for n in grads for k in grads[n]])
    log(f"[train] {tag} first step: K2 vs plain on K1's residuals grad_err="
        f"{k2_err:.3g} of max|g| ok; K1 vs plain argmax_agree={agree:.4f} "
        f"rows_within_1e-4max={close:.4f}; whole step vs whole plain step "
        f"grad_err={whole:.3g} of max|g|")
    del ref, res, plain_leaves, pa, grads

    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, TIMED, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    if not all(np.isfinite(losses)):
        fail(f"train {tag}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"train {tag}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {fused.KERNEL_TRAIN: TIMED,
                              fused.KERNEL_BWD: TIMED}:
        fail(f"train {tag}: launches {launches} in {TIMED} steps")
    for n, g in trainer.params.items():
        for k, v in g.items():
            same = torch.equal(v, before[n][k])
            if k == "beta" and not same:
                fail(f"train {tag}: beta moved")
            if k != "beta" and same:
                fail(f"train {tag}: {n}.{k} did not change")
    acc = float((trainer.predict_logits(x).argmax(1) == y).float().mean())
    step_ms = seconds / TIMED * 1e3
    log(f"[train] {tag} ttfs {TIMED} steps of {TRAIN_B}: {step_ms:.3f} ms a "
        f"step = {TRAIN_B * TIMED / seconds:.1f} img/s; loss first5="
        f"{first:.4f} last5={last:.4f}; batch accuracy={acc:.4f}; launches="
        f"{json.dumps(launched(launches))} [{card_line()}]")
    log(f"[train] {tag} ttfs losses={[round(v, 3) for v in losses]}")
    args = flagship_head_args(cfg, trainer.params, lat)
    rows = train_kernel_rows(tag, args, md, launches, k1_err, k2_err, "ttfs")

    # The periodic encoding at the production tau: most features fire at
    # every step.  For the times only.
    enc_p = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
    periodic = Trainer(cfg, seed=0, encode_config=enc_p, device="cuda")
    timed_steps(periodic, batches, 1)
    plosses, pseconds = timed_steps(periodic, batches, 10)
    if not all(np.isfinite([float(v) for v in plosses])):
        fail(f"train {tag}: non-finite loss with periodic encoding")
    log(f"[train] {tag} periodic 10 steps of {TRAIN_B}: "
        f"{pseconds / 10 * 1e3:.3f} ms a step = "
        f"{TRAIN_B * 10 / pseconds:.1f} img/s [{card_line()}]")
    pargs = flagship_head_args(cfg, periodic.params, lat, use_periods=True)
    train_kernel_rows(tag, pargs, md, launches, 0.0, 0.0, "periodic")

    # A count regularizer keeps the kernel pair (the _counts variants).
    reg = Trainer(cfg, seed=0, reg_fn=L2SpikesPerNeuron(scale=1e-9),
                  encode_config=enc, device="cuda")
    fused.reset_launch_counts()
    rlosses, _ = timed_steps(reg, batches, 3)
    got = fused.launch_counts()
    if launched(got) != {fused.KERNEL_TRAIN: 3, fused.KERNEL_BWD: 3}:
        fail(f"train {tag}: count-regularized launches {got}")
    if not all(np.isfinite([float(v) for v in rlosses])):
        fail(f"train {tag}: non-finite count-regularized loss")
    log(f"[train] {tag} L2SpikesPerNeuron 3 steps: launches="
        f"{json.dumps(launched(got))} losses={[round(float(v), 4) for v in rlosses]}")
    return rows


# ---------------------------------------------------------------------------
# Phases 6 and 7: the deep network (784-128-128-96-10) served and trained
# ---------------------------------------------------------------------------
DEEP_TIMED = 20
L0_SITE = ("fused_head.cu", "pallas_fused.py:703")
L0_BWD_SITE = ("fused_layer0_bwd.cu", "pallas_fused.py:1092")
MID_SITE = ("fused_mid.cu", "pallas_fused_mid.py:540")
MID_BWD_SITE = ("fused_mid_bwd.cu", "pallas_fused_mid.py:673")


def deep_cfg(matmul_dtype):
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=list(DEEP_WIDTHS),
        hidden_layer_type=pt.LayerType.ALIF, use_recurrent_connection=True,
        learn_beta=True, int_time_steps=100, matmul_dtype=matmul_dtype,
    )


def deep_paths(training: bool):
    both = (lambda f, b: f"cuda:{f}+{b}") if training else (
        lambda f, b: f"cuda:{f}")
    return [both(fused.KERNEL_L0, fused.KERNEL_L0_BWD),
            both(fused.KERNEL_MID, fused.KERNEL_MID_BWD),
            both(fused.KERNEL_MID, fused.KERNEL_MID_BWD) + "[head]"]


def kernel_row(label, name, site, launches, err, ms, plain_ms, nbytes, ops,
               md, library_ms=None):
    """One row of the kernels line, and its log line.  ``nbytes``: every
    input read once and every output written once; ``ops``: what this
    run's data needs (one add per selected weight of a 0/1 product, 2 FLOP
    a term of a dense one, ~10-12 a (row, step, unit) of the chain)."""
    peak = H100_F32_FLOPS if md == torch.float32 else H100_BF16_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    log(f"[{label}] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}; "
        f"bytes={nbytes} ops={ops} -> bound {max(t_bytes, t_ops):.5f} ms; "
        f"launches={launches} err={err:.3g} [{card_line()}]")
    return {
        "name": name, "route": "cuda",
        "source": f"snnimageclassification_tpu_torch/csrc/{site[0]}",
        "replaces": f"snnimageclassification_tpu/ops/{site[1]}",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms}


def deep_kernel_rows(label, tag, cfg, params, x, use_periods, train,
                     launches):
    """Each kernel of the deep path alone on one batch, at the arguments
    ``forward_logits_pixels`` gives it: against its plain version on the
    same input (the forward kernels on the kernel's trace of the layer
    before, the backward kernels on the forward kernel's residuals and a
    random cotangent), timed, with its bound.  No single PyTorch call
    computes any of them."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    f32 = md == torch.float32
    it = md.itemsize
    T = cfg.int_time_steps
    B, F = x.shape
    lat = pixels_to_firing_periods(x, t_max=float(T)).contiguous()
    layers = cfg.layer_configs
    O = layers[-1][1].output_size
    kappa = layers[-1][1].kappa
    ro = params[layers[-1][0]]
    w_out = ro["w_in"].detach().to(md).contiguous()
    b_out = ro["b"].detach().to(torch.float32).contiguous()
    rng = np.random.default_rng(6)
    gbar = 1e-4 if f32 else 2.0 ** -7
    n_fwd, n_plain = 10, 3
    rows = []
    z_in, in_spikes, n_in = None, input_spike_count(lat, T, use_periods), F
    for idx, (name, lcfg) in enumerate(layers[:-1]):
        p = params[name]
        H = lcfg.output_size
        head = idx == len(layers) - 2
        w_in = p["w_in"].detach().to(md).contiguous()
        w_rec = masked_recurrent(lcfg, p).detach().to(md).contiguous()
        beta = p["beta"].detach()
        sc = (lcfg.alpha, lcfg.rho, lcfg.threshold)
        weights = (n_in * H + H * H + (H * O if head else 0)) * it
        trace = T * B * H * it
        if idx == 0:
            def fwd(plain, tr=train):
                fn = fused._layer0_reference if plain else fused._layer0_cuda
                return fn(lat, w_in, w_rec, beta, T, use_periods, True, *sc,
                          tr, False, False)
            kname, site, bsite = fused.KERNEL_L0, L0_SITE, L0_BWD_SITE
            bname = fused.KERNEL_L0_BWD
            in_bytes = B * F * 4
        else:
            def fwd(plain, tr=train, z_in=z_in, head=head):
                fn = fused_mid._mid_reference if plain else fused_mid._mid_cuda
                return fn(z_in, w_in, w_rec, beta, w_out if head else None,
                          b_out if head else None, T, True, *sc,
                          kappa if head else 0.0, tr, False, False, False)
            kname, site, bsite = fused.KERNEL_MID, MID_SITE, MID_BWD_SITE
            bname = fused.KERNEL_MID_BWD
            in_bytes = T * B * n_in * it
        out, ref = fwd(False), fwd(True)
        torch.cuda.synchronize()
        if idx == 0:
            z, res = out[0], out[1]
            share = rows_equal(z, ref[0])
            err = float((z.float() - ref[0].float()).abs().max())
        elif not head:
            z, res = out[1], out[2]
            share = rows_equal(z, ref[1])
            err = float((z.float() - ref[1].float()).abs().max())
        else:
            z, res = None, out[2]
            agree, close, err, _ = compare_flagship(out[0], ref[0])
            share = close
            if agree < 0.995 or close < 0.99:
                fail(f"{label} {name}: mid head below the bar ({agree:.4f}, "
                     f"{close:.4f})")
            if not bool(torch.isfinite(out[0]).all()):
                fail(f"{label} {name}: non-finite logits")
        if share < 0.995:
            fail(f"{label} {name}: {share:.5f} of rows agree with the plain "
                 "version")
        ms = cuda_ms(lambda: fwd(False), n_fwd)
        plain_ms = cuda_ms(lambda: fwd(True), n_plain, warmup=1)
        if head:  # its spikes: the counts of one more forward
            hidden = int(fused_mid._mid_cuda(
                z_in, w_in, w_rec, beta, w_out, b_out, T, True, *sc, kappa,
                False, False, True, False)[5].sum())
        else:
            hidden = int(z.float().sum())
        nbytes = (in_bytes + weights + 4 + (B * O * 4 if head else trace)
                  + (trace if train else 0) + (B * O * 4 if head and train
                                               else 0))
        ops = (in_spikes * H + hidden * (H + (O if head else 0))
               + 10 * B * T * H + (3 * B * T * O if head else 0))
        mode = ("head" if head else "z") if idx else ""
        full = f"{kname}[{' '.join(filter(None, (tag, mode, 'train' if train else '')))}]"
        log(f"[{label}] {name}: input spikes={in_spikes} spikes={hidden} "
            f"({hidden / (B * T * H):.4f} of unit-steps); rows agreeing "
            f"with the plain version={share:.5f}")
        n_launch = launches[kname] if idx == 0 else launches[kname] // 2
        rows.append(kernel_row(label, full, site, n_launch, err, ms, plain_ms,
                               nbytes, ops, md))
        if train:
            if head:
                tstar = out[4]
                g_logits = rand_w(rng, (B, O), 1.0 / B)

                def bwd(plain, z_in=z_in, res=res, tstar=tstar,
                        g_logits=g_logits):
                    fn = (fused_mid._mid_bwd_reference if plain
                          else fused_mid._mid_bwd_cuda)
                    return fn(g_logits, None, tstar, None, None, res, None,
                              False, z_in, w_in, w_rec, beta, w_out, T,
                              lcfg.alpha, lcfg.threshold, lcfg.gamma, kappa,
                              lcfg.spike_func)
            else:
                g_z = rand_w(rng, tuple(z.shape), 1.0 / B, md)
                if idx == 0:
                    def bwd(plain, z=z, res=res, g_z=g_z):
                        fn = (fused._layer0_bwd_reference if plain
                              else fused._layer0_bwd_cuda)
                        return fn(g_z, z, res, None, False, lat, w_in, w_rec,
                                  beta, T, use_periods, lcfg.alpha,
                                  lcfg.threshold, lcfg.gamma,
                                  lcfg.spike_func)
                else:
                    def bwd(plain, z_in=z_in, z=z, res=res, g_z=g_z):
                        fn = (fused_mid._mid_bwd_reference if plain
                              else fused_mid._mid_bwd_cuda)
                        return fn(None, None, None, g_z, z, res, None, False,
                                  z_in, w_in, w_rec, beta, None, T,
                                  lcfg.alpha, lcfg.threshold, lcfg.gamma,
                                  0.0, lcfg.spike_func)
            gerr = check_grads(f"{label} {name} backward",
                               lambda: bwd(False), lambda: bwd(True), gbar)
            bms = cuda_ms(lambda: bwd(False), n_fwd)
            bplain = cuda_ms(lambda: bwd(True), n_plain, warmup=1)
            # Read: the residual, and g_z and z (z-layer) or g_logits and
            # tstar (head), the input and the weights; written: the
            # weights' gradients and, past layer 0, g_z_in.
            bbytes = (trace * (1 if head else 3) + in_bytes + 2 * weights
                      + (2 * B * O * 4 if head else 0)
                      + (in_bytes if idx else 0))
            bops = (2 * B * T * H * H + (2 * B * T * H * n_in if idx else 0)
                    + (2 * B * T * H * O if head else 0) + in_spikes * H
                    + hidden * (H + (O if head else 0)) + 12 * B * T * H)
            bfull = f"{bname}[{' '.join(filter(None, (tag, mode)))}]"
            n_launch = (launches[bname] if idx == 0
                        else launches[bname] // 2)
            rows.append(kernel_row(label, bfull, bsite, n_launch, gerr, bms,
                                   bplain, bbytes, bops, md))
            del bwd
        z_in, in_spikes, n_in = z, (0 if head else hidden), H
        del out, ref, fwd
    torch.cuda.empty_cache()
    return rows


def phase_deep_serve(matmul_dtype: str) -> list:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"deep-serve {tag}"
    cfg = deep_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in
             model_lib.explain_dispatch(cfg, enc, device="cuda")]
    if paths != deep_paths(False):
        fail(f"{label}: dispatch is {paths}")
    reqs, launches = serve_requests(
        label, cfg, params, enc, {fused.KERNEL_L0: 1, fused.KERNEL_MID: 2})
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    with torch.no_grad():
        ms = cuda_ms(lambda: model_lib.forward_logits_pixels(
            cfg, params, x, enc, device="cuda"), 10)
    log(f"[{label}] forward_logits_pixels on a 4096-row batch: {ms:.4f} ms "
        f"[{card_line()}]")
    return deep_kernel_rows(label, tag, cfg, params, x, False, False,
                            launches)


def phase_deep_train(matmul_dtype: str) -> list:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"deep-train {tag}"
    cfg = deep_cfg(matmul_dtype)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, device="cuda", training=True)]
    if paths != deep_paths(True):
        fail(f"{label}: dispatch is {paths}")
    trainer = Trainer(cfg, seed=0, lr=1e-3, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    batches = synthetic_task(4)
    a_step = {fused.KERNEL_L0: 1, fused.KERNEL_MID: 2,
              fused.KERNEL_MID_BWD: 2, fused.KERNEL_L0_BWD: 1}

    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, DEEP_TIMED, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {k: n * DEEP_TIMED for k, n in a_step.items()}:
        fail(f"{label}: launches {launches} in {DEEP_TIMED} steps")
    for n, g in trainer.params.items():
        for k, v in g.items():
            same = torch.equal(v, before[n][k])
            if k == "beta" and not same:
                fail(f"{label}: {n}.beta moved")
            if k != "beta" and same:
                fail(f"{label}: {n}.{k} did not change")
    x, y = batches[0]
    acc = float((trainer.predict_logits(x).argmax(1) == y).float().mean())
    log(f"[{label}] ttfs {DEEP_TIMED} steps of {TRAIN_B}: "
        f"{seconds / DEEP_TIMED * 1e3:.3f} ms a step = "
        f"{TRAIN_B * DEEP_TIMED / seconds:.1f} img/s; loss first5="
        f"{first:.4f} last5={last:.4f}; batch accuracy={acc:.4f}; launches="
        f"{json.dumps(launched(launches))} [{card_line()}]")
    log(f"[{label}] ttfs losses={[round(v, 3) for v in losses]}")
    rows = deep_kernel_rows(f"{label} ttfs", tag, cfg, trainer.params, x,
                            False, True, launches)

    # Periodic encoding, for the times and the launches.
    enc_p = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
    periodic = Trainer(cfg, seed=0, encode_config=enc_p, device="cuda")
    timed_steps(periodic, batches, 1)
    fused.reset_launch_counts()
    plosses, pseconds = timed_steps(periodic, batches, 5)
    got = fused.launch_counts()
    if launched(got) != {k: n * 5 for k, n in a_step.items()}:
        fail(f"{label}: periodic launches {got}")
    if not all(np.isfinite([float(v) for v in plosses])):
        fail(f"{label}: non-finite loss with periodic encoding")
    log(f"[{label}] periodic 5 steps of {TRAIN_B}: "
        f"{pseconds / 5 * 1e3:.3f} ms a step = "
        f"{TRAIN_B * 5 / pseconds:.1f} img/s [{card_line()}]")
    deep_kernel_rows(f"{label} periodic", tag, cfg, periodic.params, x, True,
                     True, got)

    # A count regularizer keeps every kernel pair (the trunk's counts are
    # sums of traces that exist anyway, the last layer's the kernel's).
    reg = Trainer(cfg, seed=0, reg_fn=L2SpikesPerNeuron(scale=1e-9),
                  encode_config=enc, device="cuda")
    fused.reset_launch_counts()
    rlosses, rseconds = timed_steps(reg, batches, 3)
    got = fused.launch_counts()
    if launched(got) != {k: n * 3 for k, n in a_step.items()}:
        fail(f"{label}: count-regularized launches {got}")
    if not all(np.isfinite([float(v) for v in rlosses])):
        fail(f"{label}: non-finite count-regularized loss")
    log(f"[{label}] L2SpikesPerNeuron 3 steps: {rseconds / 3 * 1e3:.3f} ms a "
        f"step (first step included); launches={json.dumps(launched(got))} "
        f"losses={[round(float(v), 4) for v in rlosses]}")
    return rows


# ---------------------------------------------------------------------------
# Phases 8-10: Izhikevich
# ---------------------------------------------------------------------------
IZH = IzhikevichConfig(input_size=1, output_size=1)
IZH_KP = izh.izh_kernel_params(IZH)
IZH_SITES = {  # kernel -> (its source, the TPU kernel's pl.pallas_call site)
    fused.KERNEL_IZH: ("fused_izh.cu", "pallas_fused_izh.py:464"),
    fused.KERNEL_IZH_TRAIN: ("fused_izh.cu", "pallas_fused_izh.py:464"),
    fused.KERNEL_IZH_L0: ("fused_izh.cu", "pallas_fused_izh.py:484"),
    fused.KERNEL_IZH_BWD: ("fused_izh_bwd.cu", "pallas_fused_izh.py:631"),
    fused.KERNEL_IZH_L0_BWD: ("fused_izh_bwd.cu", "pallas_fused_izh.py:631"),
    fused.KERNEL_IZH_SCAN: ("izh_scan.cu", "pallas_izh.py:157"),
    fused.KERNEL_IZH_SCAN_BWD: ("izh_scan.cu", "pallas_izh.py:211"),
}
IZH_CELL_OPS, IZH_CHAIN_OPS = 20, 24  # float32 ops a (row, step, unit)
IZH_TIMED, IZH_DEEP_TIMED = 20, 10
# dt = 30, where the models are served and trained: dt a b = -1.8 and
# 1 - dt a = 0.1, so the u carry moves the backward chain as much as v's.
IZH30 = IzhikevichConfig(input_size=1, output_size=1, dt=30.0)
IZH30_KP = izh.izh_kernel_params(IZH30)
IZH30_BAR = 1e-4  # float32 gradients of max|g| at dt = 30
WITNESS_ROWS = 256


def izh_bar(T, f32, full):
    """Gradients against the plain version on the same residuals, of
    max|g|: bf16 one rounding; float32 2e-6 (5e-6 at T = 100, four times
    the terms), 1e-4 at full width."""
    if not f32:
        return 2.0 ** -7
    if full:
        return 1e-4
    return 2e-6 if T < 100 else 5e-6


def izh_weights(rng, n_in, n, O, rec, wdtype):
    """(w_in, masked w_rec | None, w_out, b_out) at the JAX tests' scale."""
    w_rec = ((rand_w(rng, (n, n), 5e5) * (1 - torch.eye(n, device="cuda")))
             .to(wdtype) if rec else None)
    return (rand_w(rng, (n_in, n), 3e6, wdtype), w_rec,
            rand_w(rng, (n, O), 1.0, wdtype), rand_w(rng, (O,), 0.1))


def v_close(label, got, want):
    """Membrane traces: 1e-6 relative, 1e-3 mV absolute.  At this scale a
    step's input sum reaches ~1e8, where a float32 ulp is 8; a summation in
    another order moves v by ~1e-4 mV a step (dt/C = 1e-5), and T steps
    add up."""
    if not torch.allclose(got, want, rtol=1e-6, atol=1e-3):
        fail(f"{label}: v differs by {float((got - want).abs().max()):.3g}")


def check_izh(label, rng, B, F, H0, H1, O, T, rec, spike, per, wdtype, full):
    """The three Izhikevich kernel pairs at one shape: the head, layer 0,
    and ``izh_scan`` on layer 1's currents ``z0 @ W1``.  Each forward
    kernel against its plain version on the same inputs, each backward
    kernel against its plain version on the forward kernel's residuals and
    twice for equal bits.  Returns ({kernel: error}, {layer: share of rows
    with equal spikes}, {layer: firing share})."""
    f32 = wdtype == torch.float32
    bar = izh_bar(T, f32, full)
    kappa = ReadoutConfig(input_size=1, output_size=1).kappa
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    w_in, w_rec, w_out, b_out = izh_weights(rng, F, H0, O, rec, wdtype)
    head = (lat, w_in, w_rec, w_out, b_out, T, per, IZH_KP, kappa)
    errs, shares, fire = {}, {}, {}

    # The head: inference, training forward, backward.
    infer = fused_izh._head_cuda(*head, False, False)[0]
    logits, v, tstar, counts = fused_izh._head_cuda(*head, True, True)
    ref = fused_izh._head_reference(*head, True, True)
    torch.cuda.synchronize()
    if not torch.equal(logits, infer):
        fail(f"{label}: training and inference logits differ")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: non-finite logits")
    fire["hidden"] = float(counts.sum()) / (B * T * H0)
    if fire["hidden"] == 0:
        fail(f"{label}: no unit fires")
    agree, close, err, scale = compare_flagship(logits, ref[0])
    errs[fused.KERNEL_IZH] = errs[fused.KERNEL_IZH_TRAIN] = err
    shares["head"] = float((counts == ref[3]).all(1).float().mean())
    if full:
        if agree < 0.995 or close < 0.99:
            fail(f"{label}: head agreement below the bar ({agree:.4f}, "
                 f"{close:.4f})")
        same = (logits - ref[0]).abs().amax(1) <= 1e-4 * scale
        if not torch.equal(tstar[same], ref[2][same]):
            fail(f"{label}: tstar differs on rows whose logits agree")
    else:
        if not torch.allclose(logits, ref[0], atol=1e-5, rtol=1e-5):
            fail(f"{label}: logits differ by {err:.3g}")
        if not (torch.equal(tstar, ref[2]) and torch.equal(counts, ref[3])):
            fail(f"{label}: tstar or counts differ")
        v_close(f"{label} head", v, ref[1])
    del ref
    g_logits = rand_w(rng, (B, O), 1.0 / B)
    g_counts = rand_w(rng, (B, H0), 1e-3 / B)
    hb = (g_logits, g_counts, tstar, None, None, v, lat, w_in, w_rec, w_out,
          T, per, IZH_KP, IZH.gamma, kappa, spike)
    errs[fused.KERNEL_IZH_BWD] = check_grads(
        f"{label} head backward", lambda: fused_izh._bwd_cuda(*hb),
        lambda: fused_izh._bwd_reference(*hb), bar)

    # Layer 0: the head's template without the readout, so its v and z
    # are the head's bits.
    z0, v0 = fused_izh._layer0_cuda(lat, w_in, w_rec, T, per, IZH_KP, True)
    z0_inf = fused_izh._layer0_cuda(lat, w_in, w_rec, T, per, IZH_KP,
                                    False)[0]
    if not (torch.equal(z0, z0_inf) and torch.equal(v0, v)
            and torch.equal(z0, (v >= IZH.v_peak).float())):
        fail(f"{label}: layer 0 differs from the head's scan")
    del hb, v
    z0p, v0p = fused_izh._layer0_reference(lat, w_in, w_rec, T, per, IZH_KP,
                                           True)
    shares["layer 0"] = rows_equal(z0, z0p)
    errs[fused.KERNEL_IZH_L0] = float((z0 - z0p).abs().max())
    if not full:
        if shares["layer 0"] < 1.0:
            fail(f"{label}: layer-0 spikes differ from the plain version's")
        v_close(f"{label} layer 0", v0, v0p)
    del z0p, v0p
    g_z = rand_w(rng, (T, B, H0), 1.0 / B)
    lb = (None, None, None, g_z, z0, v0, lat, w_in, w_rec, None, T, per,
          IZH_KP, IZH.gamma, 0.0, spike)
    errs[fused.KERNEL_IZH_L0_BWD] = check_grads(
        f"{label} layer-0 backward", lambda: fused_izh._bwd_cuda(*lb),
        lambda: fused_izh._bwd_reference(*lb), bar)
    del lb, g_z, v0

    # izh_scan on the currents of a layer past the first.
    w1, w_rec1, _, _ = izh_weights(rng, H0, H1, 1, rec, wdtype)
    cur = (z0 @ w1.float()).contiguous()
    z1, v1 = izh._scan_cuda(cur, w_rec1, IZH_KP, True)
    z1_inf = izh._scan_cuda(cur, w_rec1, IZH_KP, False)[0]
    z1p, v1p = izh._scan_reference(cur, w_rec1, IZH_KP, True)
    torch.cuda.synchronize()
    if not torch.equal(z1, z1_inf):
        fail(f"{label}: scan inference and training spikes differ")
    fire["layer 0"], fire["layer 1"] = float(z0.mean()), float(z1.mean())
    if fire["layer 1"] == 0:
        fail(f"{label}: no unit of the scan fires")
    shares["scan"] = rows_equal(z1, z1p)
    errs[fused.KERNEL_IZH_SCAN] = float((z1 - z1p).abs().max())
    if not full:
        if shares["scan"] < 1.0:
            fail(f"{label}: scan spikes differ from the plain version's")
        v_close(f"{label} scan", v1, v1p)
    elif min(shares.values()) < 0.995:
        fail(f"{label}: spikes equal on too few rows: {shares}")
    del z1p, v1p, cur
    g_z1 = rand_w(rng, (T, B, H1), 1.0 / B)
    sb = (g_z1, z1, v1, w_rec1, IZH_KP, IZH.gamma, spike)
    errs[fused.KERNEL_IZH_SCAN_BWD] = check_grads(
        f"{label} scan backward", lambda: izh._scan_bwd_cuda(*sb),
        lambda: izh._scan_bwd_reference(*sb), bar)
    return errs, shares, fire


def izh30_bwd_checks(label, fwd, kp, gamma, spike, f32, rng):
    """Each Izhikevich backward kernel against its plain version at dt =
    30 on its forward kernel's residuals and twice for equal bits.  At the
    JAX tests' scale (dt = 1e-3, check_izh) dt a b = -6e-5 and the u carry
    moves a gradient by ~6e-8 of max|g|, under every bar there; at dt = 30
    it dominates.  The forwards are not held together here: the cell
    amplifies a last-bit difference of v about threefold a step between
    spikes.  ``fwd``: {"head": (lat, w_in, w_rec, w_out, T, per, kappa,
    tstar, v)}, {"layer 0": (lat, w_in, w_rec, T, per, z0, v0)}, {"scan":
    (w_rec1, z1, v1)}, any of them.  Bar 1e-4 of max|g| (bfloat16: one
    rounding).  Returns {kernel: error}."""
    bar = IZH30_BAR if f32 else 2.0 ** -7
    errs = {}
    if "head" in fwd:
        lat, w_in, w_rec, w_out, T, per, kappa, tstar, v = fwd["head"]
        B, O = tstar.shape
        hb = (rand_w(rng, (B, O), 1.0 / B), None, tstar, None, None, v, lat,
              w_in, w_rec, w_out, T, per, kp, gamma, kappa, spike)
        errs[fused.KERNEL_IZH_BWD] = check_grads(
            f"{label} head backward dt=30", lambda: fused_izh._bwd_cuda(*hb),
            lambda: fused_izh._bwd_reference(*hb), bar)
    if "layer 0" in fwd:
        lat, w_in, w_rec, T, per, z0, v0 = fwd["layer 0"]
        g_z = rand_w(rng, tuple(z0.shape), 1.0 / z0.shape[1])
        lb = (None, None, None, g_z, z0, v0, lat, w_in, w_rec, None, T, per,
              kp, gamma, 0.0, spike)
        errs[fused.KERNEL_IZH_L0_BWD] = check_grads(
            f"{label} layer-0 backward dt=30",
            lambda: fused_izh._bwd_cuda(*lb),
            lambda: fused_izh._bwd_reference(*lb), bar)
    if "scan" in fwd:
        w_rec1, z1, v1 = fwd["scan"]
        sb = (rand_w(rng, tuple(z1.shape), 1.0 / z1.shape[1]), z1, v1, w_rec1,
              kp, gamma, spike)
        errs[fused.KERNEL_IZH_SCAN_BWD] = check_grads(
            f"{label} scan backward dt=30", lambda: izh._scan_bwd_cuda(*sb),
            lambda: izh._scan_bwd_reference(*sb), bar)
    return errs


def check_izh_dt30(label, rng, B, F, H0, H1, O, T, rec, spike, per, wdtype):
    """The three Izhikevich kernel pairs at dt = 30 with init-scale weights
    (N(0, 1)): each forward kernel runs, some unit fires, and each backward
    kernel holds its plain version on the forward's residuals
    (izh30_bwd_checks).  Returns ({kernel: error}, lowest firing share)."""
    kappa = ReadoutConfig(input_size=1, output_size=1).kappa
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(pixels, t_max=float(T)).contiguous()
    eye = 1 - torch.eye(H0, device="cuda")
    w_in = rand_w(rng, (F, H0), 1.0, wdtype)
    w_rec = (rand_w(rng, (H0, H0), 1.0) * eye).to(wdtype) if rec else None
    w_out = rand_w(rng, (H0, O), 1.0, wdtype)
    b_out = rand_w(rng, (O,), 0.1)
    _, v, tstar, counts = fused_izh._head_cuda(
        lat, w_in, w_rec, w_out, b_out, T, per, IZH30_KP, kappa, True, True)
    z0, v0 = fused_izh._layer0_cuda(lat, w_in, w_rec, T, per, IZH30_KP, True)
    w1 = rand_w(rng, (H0, H1), 1.0, wdtype)
    w_rec1 = ((rand_w(rng, (H1, H1), 1.0) * (1 - torch.eye(H1, device="cuda")))
              .to(wdtype) if rec else None)
    z1, v1 = izh._scan_cuda((z0 @ w1.float()).contiguous(), w_rec1, IZH30_KP,
                            True)
    fire = min(float(counts.sum()) / (B * T * H0), float(z0.mean()),
               float(z1.mean()))
    if fire == 0 or not bool(torch.isfinite(v).all()):
        fail(f"{label}: no unit fires or v is not finite")
    errs = izh30_bwd_checks(label, {
        "head": (lat, w_in, w_rec, w_out, T, per, kappa, tstar, v),
        "layer 0": (lat, w_in, w_rec, T, per, z0, v0),
        "scan": (w_rec1, z1, v1)}, IZH30_KP, IZH30.gamma, spike,
        wdtype == torch.float32, rng)
    return errs, fire


def phase_izh_kernels() -> None:
    """Every Izhikevich kernel against its plain version: small shapes
    (ff/rec x FastSigmoid/Phi x TTFS/periodic x T = 24, 100) and the full
    width of both Izhikevich paths (784-128-10, 784-128-128-10, B = 8192,
    T = 100, periodic), float32 and bfloat16 weights."""
    rng = np.random.default_rng(8)
    for wname, wdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        worst, lowest = 0.0, 1.0
        for rec in (True, False):
            for spike in (FS, PHI):
                for per in (False, True):
                    for T in (24, 100):
                        label = (f"izh small {'rec' if rec else 'ff'} "
                                 f"{'fs' if spike == FS else 'phi'} "
                                 f"{'periodic' if per else 'ttfs'} {wname} "
                                 f"T={T}")
                        errs, _, fire = check_izh(
                            label, rng, 37, 30, 20, 24, 10, T, rec, spike,
                            per, wdtype, False)
                        worst = max(worst, max(errs.values()))
                        lowest = min(lowest, min(fire.values()))
        log(f"[izh-kernels] 32 small cases {wname}: spikes, tstar and counts "
            f"equal, worst error {worst:.3g}, lowest firing share "
            f"{lowest:.4f} ok")
        label = f"izh full {wname}"
        errs, shares, fire = check_izh(label, rng, TRAIN_B, 784, 128, 128,
                                       10, 100, True, FS, True, wdtype, True)
        log(f"[izh-kernels] {label} B={TRAIN_B} periodic tau=20: firing "
            f"shares {json.dumps(fire)}; rows with equal spikes "
            f"{json.dumps(shares)}; errors {json.dumps(errs)} (gradients of "
            f"max|g|), reproducible")
        torch.cuda.empty_cache()
        worst, lowest = {}, 1.0
        for rec, spike, per in ((True, FS, False), (False, PHI, False),
                                (True, PHI, True), (False, FS, True)):
            label = (f"izh dt=30 {'rec' if rec else 'ff'} "
                     f"{'fs' if spike == FS else 'phi'} "
                     f"{'periodic' if per else 'ttfs'} {wname}")
            errs, fire = check_izh_dt30(label, rng, 37, 100, 20, 24, 10, 100,
                                        rec, spike, per, wdtype)
            worst = {k: max(e, worst.get(k, 0.0)) for k, e in errs.items()}
            lowest = min(lowest, fire)
        log(f"[izh-kernels] 4 cases at dt=30 {wname} (ff/rec, T=100, init "
            f"weights): backward errors of max|g| {json.dumps(worst)} within "
            f"{IZH30_BAR if wname == 'f32' else 2.0 ** -7:.3g}, lowest firing "
            f"share {lowest:.4f} ok")


def izh_cfg(matmul_dtype, hidden=128):
    """The Izhikevich flagship (bench.py's izh leg) at dt = 30, where units
    fire with the init weights; ``hidden=[128, 128]`` is the deep one."""
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=hidden,
        hidden_layer_type=pt.LayerType.Izhikevich,
        use_recurrent_connection=True, int_time_steps=100, dt=30.0,
        matmul_dtype=matmul_dtype)


def izh_layer_args(cfg, params, name):
    """(w_in, masked w_rec) of a layer as ``forward_logits_pixels`` casts
    them, and its config."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    lcfg = dict(cfg.layer_configs)[name]
    p = params[name]
    return (p["w_in"].detach().to(md).contiguous(),
            masked_recurrent(lcfg, p).detach().to(md).contiguous(), lcfg)


def izh_head_args(cfg, params, lat, use_periods):
    w_in, w_rec, lcfg = izh_layer_args(cfg, params, "input")
    md = getattr(torch, cfg.matmul_dtype_eff)
    ro = params["readout"]
    return (lat, w_in, w_rec, ro["w_in"].detach().to(md).contiguous(),
            ro["b"].detach().contiguous(), cfg.int_time_steps, use_periods,
            izh.izh_kernel_params(lcfg), cfg.layer_configs[-1][1].kappa)


def izh_row(label, tag, kernel, launches, err, ms, plain_ms, nbytes, ops,
            md):
    """A row of the kernels line; ``err`` is measured on the row's own
    inputs against the plain version."""
    return kernel_row(label, f"{kernel}[{tag}]", IZH_SITES[kernel], launches,
                      err, ms, plain_ms, nbytes, ops, md)


def ordered_sum(s, w):
    """``s @ w`` for a 0/1 ``s`` (B, K) in the kernels' order: ascending k,
    one rounding an add (masked_sum in head_common.cuh).  A column of s
    that is zero in every row adds +-0 and is skipped."""
    acc = torch.zeros((s.shape[0], w.shape[1]), device=s.device)
    for k in torch.nonzero(s.any(0)).flatten().tolist():
        acc = acc + s[:, k:k + 1] * w[k]
    return acc


def ordered_izh_head(lat, w_in, w_rec, w_out, b_out, T, kp, kappa):
    """A second plain version of the Izhikevich head (TTFS): izh._izh_loop's
    cell in the same expressions, but every sum -- input, recurrent,
    readout -- in the kernel's order instead of torch.matmul's."""
    p = dict(kp)
    C = torch.full((), p["C"], device="cuda")  # a true division, as the loop
    w_in, w_out = w_in.float(), w_out.float()
    B, H = lat.shape[0], w_in.shape[1]
    v = torch.full((B, H), p["v_rest"], device="cuda")
    u, z = torch.zeros_like(v), torch.zeros_like(v)
    v_r = torch.zeros((B, w_out.shape[1]), device="cuda")
    m = torch.full_like(v_r, float("-inf"))
    for t in range(T):
        cur = ordered_sum((lat == t).float(), w_in)
        if w_rec is not None:
            cur = cur + ordered_sum(z, w_rec.float())
        dvdt = p["k"] * (v - p["v_rest"]) * (v - p["v_th"]) - u + cur
        v_new = (v + p["dt"] * dvdt / C) * (1.0 - z) + p["c"] * z
        dudt = p["a"] * (p["b"] * (v - p["v_rest"]) - u)
        u = (u + p["dt"] * dudt) + p["d"] * z
        v = v_new
        z = (v >= p["v_peak"]).float()
        v_r = kappa * v_r + (ordered_sum(z, w_out) + b_out)
        m = torch.where(v_r > m, v_r, m)
    return m


def phase_izh_serve(matmul_dtype: str) -> dict:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"izh-serve {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = izh_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(cfg, enc)]
    if paths != [f"cuda:{fused.KERNEL_IZH}"]:
        fail(f"{label}: dispatch is {paths}")
    reqs, launches = serve_requests(label, cfg, params, enc,
                                    {fused.KERNEL_IZH: 1})
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    args = izh_head_args(cfg, params, lat, False)
    got = fused_izh._head_cuda(*args, False, False)[0]
    ref = fused_izh._head_reference(*args, False, True)
    torch.cuda.synchronize()
    agree, close, err, _ = compare_flagship(got, ref[0])
    # The second witness: on the first WITNESS_ROWS rows, the plain cell
    # with every sum in the kernel's order equals the kernel bitwise.
    n = WITNESS_ROWS
    wit = ordered_izh_head(lat[:n], *args[1:6], args[7], args[8])
    if not torch.equal(wit, got[:n]):
        fail(f"{label}: the kernel differs from the plain cell summed in its "
             f"order on {int((wit != got[:n]).any(1).sum())} of {n} rows")
    w_agree = compare_flagship(wit, ref[0][:n])[0]
    log(f"[{label}] kernel == plain cell with the kernel's summation order, "
        f"bitwise, on {n} of {n} rows; that version against the plain "
        f"version (torch.matmul sums): argmax_agree={w_agree:.4f}")
    ms = cuda_ms(lambda: fused_izh._head_cuda(*args, False, False), 25)
    plain_ms = cuda_ms(lambda: fused_izh._head_reference(*args, False, False),
                       5, warmup=1)
    B, F = lat.shape
    T, H, O = 100, 128, 10
    hidden = int(fused_izh._head_cuda(*args, False, True)[3].sum())
    in_spikes = input_spike_count(lat, T)
    log(f"[{label}] kernel vs plain at dt=30 (not gated: the cell is "
        f"unstable between spikes): argmax_agree={agree:.4f} "
        f"rows_within_1e-4max={close:.4f} max_abs_err={err:.3g}; hidden "
        f"spikes of the plain version {int(ref[3].sum())}")
    log(f"[{label}] input spikes={in_spikes} ({in_spikes / lat.numel():.4f} "
        f"of features), hidden spikes={hidden} "
        f"({hidden / (B * T * H):.4f} of unit-steps)")
    weights = (F * H + H * H + H * O) * md.itemsize
    nbytes = B * F * 4 + weights + O * 4 + B * O * 4
    ops = (in_spikes * H + hidden * (H + O) + IZH_CELL_OPS * B * T * H
           + 3 * B * T * O)
    return izh_row(label, tag, fused.KERNEL_IZH, launches[fused.KERNEL_IZH],
                   err, ms, plain_ms, nbytes, ops, md)


def izh_train_run(label, cfg, enc, a_step, n_timed, batches):
    """Train ``cfg`` from seed 0: WARMUP steps, then ``n_timed`` timed ones
    with the launch counts zeroed just before; the loss must be finite and
    fall, each step launch the kernels of ``a_step`` once, the readout's
    leaves move and every gradient be finite.  The hidden layers' share of
    weights that moved is printed, not gated: at dt = 30 their BPTT
    gradients reach ~1e24 (the cell amplifies between spikes), their
    squares overflow float32 in Adam's second moment and the step of such
    a weight is exactly 0, in the JAX reference's optax as in
    torch.optim.Adam.  Returns (trainer, launches)."""
    trainer = Trainer(cfg, seed=0, lr=1e-3, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, n_timed, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {k: n * n_timed for k, n in a_step.items()}:
        fail(f"{label}: launches {launches} in {n_timed} steps")
    moved = {f"{n}.{k}": float((v != before[n][k]).float().mean())
             for n, g in trainer.params.items() for k, v in g.items()}
    if not all(moved[f"readout.{k}"] > 0 for k in trainer.params["readout"]):
        fail(f"{label}: a readout leaf did not change: {moved}")
    _, grads = trainer.loss_and_grads(*batches[0])
    biggest = {f"{n}.{k}": float(v.abs().max())
               for n, g in grads.items() for k, v in g.items()}
    if not all(np.isfinite(list(biggest.values()))):
        fail(f"{label}: non-finite gradients {biggest}")
    log(f"[{label}] share of each leaf's weights that moved: "
        f"{json.dumps(moved)}; max|g| {json.dumps(biggest)}")
    log(f"[{label}] {n_timed} steps of {TRAIN_B}: "
        f"{seconds / n_timed * 1e3:.3f} ms a step = "
        f"{TRAIN_B * n_timed / seconds:.1f} img/s; loss first5={first:.4f} "
        f"last5={last:.4f}; launches={json.dumps(launched(launches))} "
        f"[{card_line()}]")
    log(f"[{label}] losses={[round(v, 3) for v in losses]}")
    return trainer, launches


def izh_periodic_times(label, cfg, batches, n=5):
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
    periodic = Trainer(cfg, seed=0, encode_config=enc, device="cuda")
    timed_steps(periodic, batches, 1)
    losses, seconds = timed_steps(periodic, batches, n)
    if not all(np.isfinite([float(v) for v in losses])):
        fail(f"{label}: non-finite loss with periodic encoding")
    log(f"[{label}] periodic {n} steps of {TRAIN_B}: "
        f"{seconds / n * 1e3:.3f} ms a step = "
        f"{TRAIN_B * n / seconds:.1f} img/s [{card_line()}]")


def phase_izh_train(matmul_dtype: str) -> list:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    md = getattr(torch, matmul_dtype)
    it = md.itemsize
    batches = synthetic_task(4)
    x = batches[0][0]
    T, F, H, O, B = 100, 784, 128, 10, TRAIN_B
    lat = pixels_to_firing_periods(x, t_max=float(T)).contiguous()
    in_spikes = input_spike_count(lat, T)
    trace = T * B * H * 4  # the Izhikevich traces are float32
    rows = []

    # The flagship: one head pair a step.
    label = f"izh-train {tag}"
    cfg = izh_cfg(matmul_dtype)
    enc = pt.EncodeConfig(n_steps=T)
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, training=True)]
    if paths != [f"cuda:{fused.KERNEL_IZH_TRAIN}+{fused.KERNEL_IZH_BWD}"]:
        fail(f"{label}: dispatch is {paths}")
    trainer, launches = izh_train_run(
        label, cfg, enc, {fused.KERNEL_IZH_TRAIN: 1, fused.KERNEL_IZH_BWD: 1},
        IZH_TIMED, batches)
    args = izh_head_args(cfg, trainer.params, lat, False)
    res = fused_izh._head_cuda(*args, True, False)
    plain = fused_izh._head_reference(*args, True, False)
    torch.cuda.synchronize()
    agree, close, k1_err, _ = compare_flagship(res[0], plain[0])
    hidden = int(fused_izh._head_cuda(*args, False, True)[3].sum())
    log(f"[{label}] hidden spikes={hidden} ({hidden / (B * T * H):.4f} of "
        f"unit-steps); K1 vs plain at dt=30, not gated: argmax_agree="
        f"{agree:.4f} rows_within_1e-4max={close:.4f} max_abs_err="
        f"{k1_err:.3g}")
    del plain
    lcfg = cfg.layer_configs[0][1]
    rng = np.random.default_rng(10)
    k2_err = izh30_bwd_checks(label, {"head": (*args[:4], T, False, args[8],
                                               res[2], res[1])},
                              args[7], lcfg.gamma, lcfg.spike_func,
                              md == torch.float32, rng)[fused.KERNEL_IZH_BWD]
    log(f"[{label}] K2 vs plain on K1's residuals at dt=30 (the trained "
        f"weights): {k2_err:.3g} of max|g| ok")
    g_logits = torch.full((B, O), 1.0 / B, device="cuda")
    bwd = (g_logits, None, res[2], None, None, res[1], *args[:4], T, False,
           args[7], lcfg.gamma, args[8], lcfg.spike_func)
    ms1 = cuda_ms(lambda: fused_izh._head_cuda(*args, True, False), 10)
    plain1 = cuda_ms(lambda: fused_izh._head_reference(*args, True, False),
                     3, 1)
    ms2 = cuda_ms(lambda: fused_izh._bwd_cuda(*bwd), 10)
    plain2 = cuda_ms(lambda: fused_izh._bwd_reference(*bwd), 3, 1)
    weights = (F * H + H * H + H * O) * it
    fwd_ops = (in_spikes * H + hidden * (H + O) + IZH_CELL_OPS * B * T * H
               + 3 * B * T * O)
    bwd_ops = (2 * B * T * H * (H + O) + in_spikes * H + hidden * (H + O)
               + IZH_CHAIN_OPS * B * T * H)
    rows.append(izh_row(label, tag, fused.KERNEL_IZH_TRAIN,
                        launches[fused.KERNEL_IZH_TRAIN], k1_err, ms1, plain1,
                        B * F * 4 + weights + O * 4 + trace + 2 * B * O * 4,
                        fwd_ops, md))
    rows.append(izh_row(label, tag, fused.KERNEL_IZH_BWD,
                        launches[fused.KERNEL_IZH_BWD], k2_err, ms2, plain2,
                        trace + B * F * 4 + 2 * B * O * 4 + 2 * weights
                        + O * 4, bwd_ops, md))
    del res, bwd, trainer
    izh_periodic_times(label, cfg, batches)

    # The deep network: layer 0's pair, one scan pair, the readout loop.
    label = f"izh-deep-train {tag}"
    cfg = izh_cfg(matmul_dtype, [128, 128])
    want = [f"cuda:{fused.KERNEL_IZH_L0}+{fused.KERNEL_IZH_L0_BWD}",
            f"cuda:{fused.KERNEL_IZH_SCAN}+{fused.KERNEL_IZH_SCAN_BWD}",
            "torch:loop"]
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, training=True)]
    if paths != want:
        fail(f"{label}: dispatch is {paths}")
    a_step = {fused.KERNEL_IZH_L0: 1, fused.KERNEL_IZH_L0_BWD: 1,
              fused.KERNEL_IZH_SCAN: 1, fused.KERNEL_IZH_SCAN_BWD: 1}
    trainer, launches = izh_train_run(label, cfg, enc, a_step,
                                      IZH_DEEP_TIMED, batches)
    w_in, w_rec, lcfg = izh_layer_args(cfg, trainer.params, "input")
    w1, w_rec1, _ = izh_layer_args(cfg, trainer.params, "hidden_0")
    kp = izh.izh_kernel_params(lcfg)
    l0 = (lat, w_in, w_rec, T, False, kp, True)
    z0, v0 = fused_izh._layer0_cuda(*l0)
    z0p = fused_izh._layer0_reference(*l0)[0]
    cur = (z0 @ w1.float()).contiguous()
    z1, v1 = izh._scan_cuda(cur, w_rec1, kp, True)
    z1p = izh._scan_reference(cur, w_rec1, kp, True)[0]
    torch.cuda.synchronize()
    spikes0, spikes1 = int(z0.sum()), int(z1.sum())
    log(f"[{label}] firing shares: layer 0 {spikes0 / (B * T * H):.4f}, "
        f"layer 1 {spikes1 / (B * T * H):.4f} of unit-steps; rows with "
        f"spikes equal to the plain versions' at dt=30, not gated: layer 0 "
        f"{rows_equal(z0, z0p):.4f}, scan {rows_equal(z1, z1p):.4f}")
    errs = {fused.KERNEL_IZH_L0: float((z0 - z0p).abs().max()),
            fused.KERNEL_IZH_SCAN: float((z1 - z1p).abs().max())}
    del z0p, z1p
    rng = np.random.default_rng(9)
    errs.update(izh30_bwd_checks(
        label, {"layer 0": (lat, w_in, w_rec, T, False, z0, v0),
                "scan": (w_rec1, z1, v1)}, kp, lcfg.gamma, lcfg.spike_func,
        md == torch.float32, rng))
    bwd_errs = {k: errs[k] for k in (fused.KERNEL_IZH_L0_BWD,
                                     fused.KERNEL_IZH_SCAN_BWD)}
    log(f"[{label}] backward kernels vs plain on the forward kernels' "
        f"residuals at dt=30 (the trained weights): {json.dumps(bwd_errs)} "
        f"of max|g| ok")
    g_z = rand_w(rng, (T, B, H), 1.0 / B)
    lb = (None, None, None, g_z, z0, v0, lat, w_in, w_rec, None, T, False,
          kp, lcfg.gamma, 0.0, lcfg.spike_func)
    sb = (g_z, z1, v1, w_rec1, kp, lcfg.gamma, lcfg.spike_func)
    timing = [
        (fused.KERNEL_IZH_L0, lambda: fused_izh._layer0_cuda(*l0),
         lambda: fused_izh._layer0_reference(*l0),
         B * F * 4 + (F * H + H * H) * it + 2 * trace,
         in_spikes * H + spikes0 * H + IZH_CELL_OPS * B * T * H),
        (fused.KERNEL_IZH_L0_BWD, lambda: fused_izh._bwd_cuda(*lb),
         lambda: fused_izh._bwd_reference(*lb),
         3 * trace + B * F * 4 + H * H * it + (F * H + H * H) * it,
         2 * B * T * H * H + in_spikes * H + spikes0 * H
         + IZH_CHAIN_OPS * B * T * H),
        (fused.KERNEL_IZH_SCAN,
         lambda: izh._scan_cuda(cur, w_rec1, kp, True),
         lambda: izh._scan_reference(cur, w_rec1, kp, True),
         3 * trace + H * H * it, spikes1 * H + IZH_CELL_OPS * B * T * H),
        (fused.KERNEL_IZH_SCAN_BWD, lambda: izh._scan_bwd_cuda(*sb),
         lambda: izh._scan_bwd_reference(*sb),
         4 * trace + 2 * H * H * it,
         2 * B * T * H * H + spikes1 * H + IZH_CHAIN_OPS * B * T * H),
    ]
    for kernel, fn, plain_fn, nbytes, ops in timing:
        ms = cuda_ms(fn, 10)
        plain_ms = cuda_ms(plain_fn, 3, 1)
        rows.append(izh_row(label, tag, kernel, launches[kernel],
                            errs[kernel], ms, plain_ms, nbytes, ops, md))
    del timing, lb, sb, z0, v0, z1, v1, cur, g_z, trainer
    izh_periodic_times(label, cfg, batches)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 11-13: two hidden layers as one kernel pair (784-ALIF128-ALIF128-10)
# ---------------------------------------------------------------------------
F2_SITE = ("fused2.cu", "pallas_fused2.py:434")
F2_BWD_SITE = ("fused2_bwd.cu", "pallas_fused2.py:857")
TWO_WIDTHS = (128, 128)
TWO_TIMED = 20
# Adam's step size for the two-layer network at B = 8192: at 1e-3 and
# down to 1e-4 its loss on the prototype task falls for 4-6 steps and then
# climbs, through the per-step loop as through the pair (phase 13 shows
# both at 1e-3); at 3e-5 it falls.
TWO_LR = 3e-5


def f2_random_args(rng, B, F, H1, H2, O, T, alif, rec, per, wdtype, flagship):
    """Latencies and random weights as ``fused2._fused2_cuda`` takes them
    up to ``kappa``, and gamma: at full width the production tau (most
    features fire at t = 0, as the served batches) and the init scale,
    small with tau = 20 where both layers of a small network fire."""
    alpha, rho, thr, gamma = layer_scalars(alif)
    kappa = ReadoutConfig(input_size=1, output_size=1).kappa
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    tau = {} if flagship else {"tau": 20.0}
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   **tau).contiguous()
    s0, s1, s_rec = (thr, thr, thr) if flagship else (1.5, 1.0, 0.4)
    w0, w0r = deep_layer(rng, F, H1, rec, s0, s_rec, wdtype)
    w1, w1r = deep_layer(rng, H1, H2, rec, s1, s_rec, wdtype)
    # Full width: betas of the learn_beta init's scale (N(0, thr^2)).
    b0, b1 = ((0.03, 0.02) if flagship else (1.6, 1.2)) if alif else (0, 0)
    return (lat, w0, w0r, b0, w1, w1r, b1, rand_w(rng, (H2, O), 1.0, wdtype),
            rand_w(rng, (O,), 0.1), T, per, alif, alpha, rho, thr,
            kappa), gamma


def f2_bwd_args(args, out, g_logits, g_c0, g_c1, gamma, spike):
    """``fused2._fused2_bwd_cuda``'s arguments on the training forward
    ``out``'s residuals."""
    lat, w0, w0r, b0, w1, w1r, b1, w_out = args[:8]
    _, d0, a0, d1, a1, tstar, _, _ = out
    return (g_logits, g_c0, g_c1, tstar, d0, a0, d1, a1, lat, w0, w0r, b0, w1,
            w1r, b1, w_out, args[9], args[10], args[12], args[14], gamma,
            args[15], spike)


def composed_forward(args, train, store_a):
    """The composed kernels on the pair's inputs: ``fused_layer0_fwd`` (its
    residual delta, as the pair stores) then ``fused_mid_fwd[head]``;
    returns (z0, layer-0 residual, its a, the mid head's outputs)."""
    lat, w0, w0r, b0, w1, w1r, b1, w_out, b_out, T, per, alif = args[:12]
    sc = args[12:15]
    z0, r0, a0 = fused._layer0_cuda(lat, w0, w0r, b0, T, per, alif, *sc,
                                    train, store_a, False)
    m = fused_mid._mid_cuda(z0, w1, w1r, b1, w_out, b_out, T, alif, *sc,
                            args[15], train, store_a, train, False)
    return z0, r0, a0, m


def composed_backward(args, z0, r0, a0, m, g_logits, g_c0, g_c1, gamma,
                      spike):
    """``fused_mid_bwd[head]`` then ``fused_layer0_bwd`` on the composed
    forward's residuals, the counts' cotangent of layer 0 added to its
    ``g_z`` as autograd adds it: the pair's six gradients."""
    lat, w0, w0r, b0, w1, w1r, b1, w_out, _, T, per = args[:11]
    alpha, thr, kappa = args[12], args[14], args[15]
    g_z_in, g_w1, g_w1r, g_wout, g_b = fused_mid._mid_bwd_cuda(
        g_logits, g_c1, m[4], None, None, m[2], m[3], False, z0, w1, w1r, b1,
        w_out, T, alpha, thr, gamma, kappa, spike)
    g_z = (g_z_in.float() + g_c0).to(z0.dtype).contiguous()
    g_w0, g_w0r = fused._layer0_bwd_cuda(g_z, z0, r0, a0, False, lat, w0, w0r,
                                         b0, T, per, alpha, thr, gamma, spike)
    return g_w0, g_w0r, g_w1, g_w1r, g_wout, g_b


def check_fused2(label, rng, B, F, H1, H2, O, T, alif, rec, spike, per,
                 wdtype, flagship, bar_small):
    """``fused2_fwd[_train]`` and ``fused2_bwd`` at one shape: the forward
    against its plain version (small: logits 1e-5, tstar, counts and spikes
    equal, residuals 1e-5 / 2**-7; full width: the head's row bars) and
    against the composed kernels (logits, tstar, both counts and both
    residuals bit for bit), twice for equal bits; the backward against its
    plain version on the same residuals and twice for equal bits, and at
    full width against ``fused_mid_bwd`` + ``fused_layer0_bwd`` (1e-4 of
    max|g| float32; bfloat16 2**-6: the composed pair rounds layer 0's
    ``g_z`` to bfloat16, the pair keeps it float32, and each gradient is
    rounded once more).  Returns (agree, close, logit error,
    gradient error vs plain, gradient error vs composed, firing shares)."""
    f32 = wdtype == torch.float32
    store_a = alif and spike == PHI
    args, gamma = f2_random_args(rng, B, F, H1, H2, O, T, alif, rec, per,
                                 wdtype, flagship)
    infer = fused2._fused2_cuda(*args, False, False, False)[0]
    out = fused2._fused2_cuda(*args, True, store_a, True)
    again = fused2._fused2_cuda(*args, True, store_a, True)
    ref = fused2._fused2_reference(*args, True, store_a, True)
    torch.cuda.synchronize()
    if not torch.equal(out[0], infer):
        fail(f"{label}: training and inference logits differ")
    for g, g2 in zip(out, again):
        if g is not None and not torch.equal(g, g2):
            fail(f"{label}: the forward is not reproducible bit for bit")
    logits, d0, a0, d1, a1, tstar, c0, c1 = out
    fire = (float(c0.sum()) / (B * T * H1), float(c1.sum()) / (B * T * H2))
    if min(fire) == 0:
        fail(f"{label}: a layer does not fire {fire}")
    agree, close, err, scale = compare_flagship(logits, ref[0])
    if flagship:
        if agree < 0.995 or close < 0.99:
            fail(f"{label}: agreement below the bar ({agree:.4f}, "
                 f"{close:.4f})")
        same = (logits - ref[0]).abs().amax(1) <= 1e-4 * scale
        if not torch.equal(tstar[same], ref[5][same]):
            fail(f"{label}: tstar differs on rows whose logits agree")
    else:
        if not torch.allclose(logits, ref[0], atol=1e-5, rtol=1e-5):
            fail(f"{label}: logits differ by {err:.3g}")
        if not (torch.equal(tstar, ref[5]) and torch.equal(c0, ref[6])
                and torch.equal(c1, ref[7])):
            fail(f"{label}: tstar or counts differ")
        for name, g, p in (("d0", d0, ref[1]), ("d1", d1, ref[3])):
            if not torch.equal(g.float() >= 0, p.float() >= 0):
                fail(f"{label}: {name}'s spikes differ")
            trace_close(f"{label} {name}", g, p, f32)
        trace_close(f"{label} a0", a0, ref[2], f32)
        trace_close(f"{label} a1", a1, ref[4], f32)
    del ref
    z0, r0, ra0, m = composed_forward(args, True, store_a)
    torch.cuda.synchronize()
    if not (torch.equal(logits, m[0]) and torch.equal(tstar, m[4])
            and torch.equal(c1, m[5]) and torch.equal(c0, z0.float().sum(0))):
        fail(f"{label}: logits, tstar or counts differ from the composed "
             "kernels'")
    if not (torch.equal(d0, r0) and torch.equal(d1, m[2])
            and (a0 is None or (torch.equal(a0, ra0)
                                and torch.equal(a1, m[3])))):
        fail(f"{label}: residuals differ from the composed kernels'")
    g_logits = rand_w(rng, (B, O), 1.0 / B)
    g_c0 = rand_w(rng, (B, H1), 1e-3 / B)
    g_c1 = rand_w(rng, (B, H2), 1e-3 / B)
    bargs = f2_bwd_args(args, out, g_logits, g_c0, g_c1, gamma, spike)
    gbar = 2.0 ** -7 if not f32 else (1e-4 if flagship else bar_small)
    gerr = check_grads(f"{label} backward",
                       lambda: fused2._fused2_bwd_cuda(*bargs),
                       lambda: fused2._fused2_bwd_reference(*bargs), gbar)
    cerr = 0.0
    if flagship:
        got = fused2._fused2_bwd_cuda(*bargs)
        want = composed_backward(args, z0, r0, ra0, m, g_logits, g_c0, g_c1,
                                 gamma, spike)
        cerr = grad_error(got, want)
        if cerr > (1e-4 if f32 else 2.0 ** -6):
            fail(f"{label}: gradients differ from the composed kernels' by "
                 f"{cerr:.3g} of max|g|")
    return agree, close, err, gerr, cerr, fire


def phase_fused2_kernels() -> None:
    """Phase 11: ``fused2_fwd[_train]`` and ``fused2_bwd`` against their
    plain versions on phase 3b's grid (LIF/ALIF x ff/rec x
    FastSigmoid/Phi, T = 24 TTFS and periodic, T = 100, f32 and bf16,
    B = 37, 30-20-24-10: forward 1e-5, backward 2e-6 of max|g| (5e-6 at T =
    100), 2**-7 bf16) and against the composed kernels bit for bit; then
    784-128-128-10 at B = 8192, T = 100, ALIF recurrent, TTFS and periodic,
    f32 and bf16: the composed kernels' logits, tstar and counts bit for
    bit, their gradients within 1e-4 (2**-6 bf16) of max|g|."""
    rng = np.random.default_rng(12)
    for wname, wdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        worst, worst_g = 0.0, 0.0
        for name, alif, rec, spike in DEEP_CASES:
            for T, per in ((24, False), (24, True), (100, False)):
                label = (f"fused2 small {name} {wname} T={T} "
                         f"{'periodic' if per else 'ttfs'}")
                _, _, err, gerr, _, _ = check_fused2(
                    label, rng, 37, 30, 20, 24, 10, T, alif, rec, spike, per,
                    wdtype, False, 2e-6 if T < 100 else 5e-6)
                worst, worst_g = max(worst, err), max(worst_g, gerr)
        log(f"[fused2-kernels] 24 small cases {wname}: logits err <= "
            f"{worst:.3g}, tstar, counts and spikes equal the plain "
            f"version's; logits, tstar, counts and residuals equal the "
            f"composed kernels' bitwise; grad_err <= {worst_g:.3g} of max|g|,"
            f" reproducible")
        for per in (False, True):
            label = (f"fused2 full alif-rec-fs {wname} "
                     f"{'periodic' if per else 'ttfs'}")
            agree, close, err, gerr, cerr, fire = check_fused2(
                label, rng, TRAIN_B, 784, *TWO_WIDTHS, 10, 100, True, True, FS,
                per, wdtype, True, 0.0)
            log(f"[fused2-kernels] {label} B={TRAIN_B}: firing shares "
                f"{fire[0]:.4f} / {fire[1]:.4f}; logits, tstar, both counts "
                f"and residuals bitwise the composed kernels'; vs plain "
                f"argmax_agree={agree:.5f} rows_within_1e-4max={close:.5f} "
                f"max_abs_err={err:.3g}; grad_err vs plain={gerr:.3g}, vs "
                f"composed kernels={cerr:.3g} of max|g|, reproducible")
            torch.cuda.empty_cache()


def twolayer_cfg(matmul_dtype):
    """``bench.py``'s twolayer leg (bench.py:176-183)."""
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=list(TWO_WIDTHS),
        hidden_layer_type=pt.LayerType.ALIF, use_recurrent_connection=True,
        learn_beta=True, int_time_steps=100, matmul_dtype=matmul_dtype)


def twolayer_args(cfg, params, lat, use_periods=False):
    """The pair's arguments as ``forward_logits_pixels`` builds them, and
    (gamma, surrogate)."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    (n0, c0), (n1, c1), (nl, cl) = cfg.layer_configs
    p0, p1, ro = params[n0], params[n1], params[nl]

    def cast(t):
        return t.detach().to(md).contiguous()

    return (lat, cast(p0["w_in"]), cast(masked_recurrent(c0, p0)),
            p0["beta"].detach(), cast(p1["w_in"]),
            cast(masked_recurrent(c1, p1)), p1["beta"].detach(),
            cast(ro["w_in"]), ro["b"].detach().contiguous(),
            cfg.int_time_steps, use_periods, True, c0.alpha, c0.rho,
            c0.threshold, cl.kappa), (c0.gamma, c0.spike_func)


def twolayer_work(args, spikes0, spikes1, train, itemsize):
    """(bytes, operations) of the pair's forward on these inputs: each
    input read once, each output written once; one add per selected weight
    of each 0/1 product (input spikes x H1, layer-0 spikes x (H1 + H2),
    layer-1 spikes x (H2 + O)), ~10 float32 operations per (row, step,
    unit) of each layer and 3 per (row, step, output) of the readout."""
    lat, T = args[0], args[9]
    B, F = lat.shape
    H1, H2, O = args[1].shape[1], args[4].shape[1], args[7].shape[1]
    weights = (F * H1 + H1 * H1 + H1 * H2 + H2 * H2 + H2 * O) * itemsize
    nbytes = lat.numel() * 4 + weights + O * 4 + 8 + B * O * 4
    if train:
        nbytes += T * B * (H1 + H2) * itemsize + B * O * 4
    in_spikes = input_spike_count(lat, T, args[10])
    ops = (in_spikes * H1 + spikes0 * (H1 + H2) + spikes1 * (H2 + O)
           + 10 * B * T * (H1 + H2) + 3 * B * T * O)
    return nbytes, ops, in_spikes


def twolayer_spikes(args):
    """Both layers' spikes over the run: the training kernel's counts."""
    out = fused2._fused2_cuda(*args, False, False, True)
    return int(out[6].sum()), int(out[7].sum())


def phase_twolayer_serve(matmul_dtype: str) -> dict:
    """Phase 12: 784-ALIF128-ALIF128-10 served as in phase 4; one
    ``fused2_fwd`` launch a batch and no layer-0 or mid kernel; the kernel
    alone on a 4096-row batch against its plain version and against the
    composed kernels (bitwise), each timed."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"twolayer-serve {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = twolayer_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(cfg, enc)]
    if paths != [f"cuda:{fused.KERNEL_2}"]:
        fail(f"{label}: dispatch is {paths}")
    reqs, launches = serve_requests(label, cfg, params, enc,
                                    {fused.KERNEL_2: 1})
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    args, _ = twolayer_args(cfg, params, lat)
    got = fused2._fused2_cuda(*args, False, False, False)[0]
    ref = fused2._fused2_reference(*args, False, False, False)[0]
    comp = composed_forward(args, False, False)[3][0]
    torch.cuda.synchronize()
    if not torch.equal(got, comp):
        fail(f"{label}: the pair's logits differ from the composed kernels'")
    agree, close, err, _ = compare_flagship(got, ref)
    if agree < 0.995 or close < 0.99:
        fail(f"{label}: kernel disagrees with its plain version")
    ms = cuda_ms(lambda: fused2._fused2_cuda(*args, False, False, False), 25)
    plain_ms = cuda_ms(lambda: fused2._fused2_reference(
        *args, False, False, False), 5, warmup=1)
    comp_ms = cuda_ms(lambda: composed_forward(args, False, False), 25)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model_lib.forward_logits_pixels(
            cfg, params, x, enc, device="cuda"), 10)
    spikes0, spikes1 = twolayer_spikes(args)
    nbytes, ops, in_spikes = twolayer_work(args, spikes0, spikes1, False,
                                           md.itemsize)
    B = lat.shape[0]
    log(f"[{label}] the pair == the composed kernels bitwise on the served "
        f"batch; vs plain argmax_agree={agree:.4f} rows_within_1e-4max="
        f"{close:.4f} max_abs_err={err:.3g}; input spikes={in_spikes}, "
        f"spikes layer 0={spikes0} ({spikes0 / (B * 100 * 128):.4f}), layer "
        f"1={spikes1} ({spikes1 / (B * 100 * 128):.4f}) of unit-steps")
    log(f"[{label}] per 4096-row batch: {fused.KERNEL_2} {ms:.4f} ms = "
        f"{B / ms * 1e3:.1f} img/s; composed fused_layer0_fwd + "
        f"fused_mid_fwd[head] {comp_ms:.4f} ms = {B / comp_ms * 1e3:.1f} "
        f"img/s; forward_logits_pixels {fwd_ms:.4f} ms [{card_line()}]")
    return kernel_row(label, f"{fused.KERNEL_2}[{tag}]", F2_SITE,
                      launches[fused.KERNEL_2], err, ms, plain_ms, nbytes,
                      ops, md)


def phase_twolayer_train(matmul_dtype: str) -> list:
    """Phase 13: 784-ALIF128-ALIF128-10 through ``Trainer`` at batch 8192:
    3 warm-up and TWO_TIMED timed TTFS steps (finite falling loss, both
    betas bitwise, every trained leaf moves, one ``fused2_fwd_train`` and
    one ``fused2_bwd`` launch a step); each kernel alone on a training batch
    against its plain version (the backward on the forward kernel's
    residuals), timed beside the composed kernels on the same batch, and a
    whole forward + backward of the loss through the pair and through the
    composed public functions; f32: at lr 1e-3 the first step's gradients
    against the per-step loop's and ten steps' losses of both; 5 periodic
    steps (times) and 3 with ``L2SpikesPerNeuron`` (launches)."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"twolayer-train {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = twolayer_cfg(matmul_dtype)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, device="cuda", training=True)]
    if paths != [f"cuda:{fused.KERNEL_2_TRAIN}+{fused.KERNEL_2_BWD}"]:
        fail(f"{label}: dispatch is {paths}")
    trainer = Trainer(cfg, seed=0, lr=TWO_LR, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    batches = synthetic_task(4)
    a_step = {fused.KERNEL_2_TRAIN: 1, fused.KERNEL_2_BWD: 1}

    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, TWO_TIMED, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    log(f"[{label}] ttfs losses={[round(v, 3) for v in losses]}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {k: n * TWO_TIMED for k, n in a_step.items()}:
        fail(f"{label}: launches {launches} in {TWO_TIMED} steps")
    for n, g in trainer.params.items():
        for k, v in g.items():
            same = torch.equal(v, before[n][k])
            if k == "beta" and not same:
                fail(f"{label}: {n}.beta moved")
            if k != "beta" and same:
                fail(f"{label}: {n}.{k} did not change")
    x, y = batches[0]
    step_ms = seconds / TWO_TIMED * 1e3
    log(f"[{label}] ttfs {TWO_TIMED} steps of {TRAIN_B}: {step_ms:.3f} ms a "
        f"step = {TRAIN_B * TWO_TIMED / seconds:.1f} img/s; loss first5="
        f"{first:.4f} last5={last:.4f}; launches="
        f"{json.dumps(launched(launches))} [{card_line()}]")

    # Each kernel alone on the trained weights and batch 0.
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    args, (gamma, spike) = twolayer_args(cfg, trainer.params, lat)
    out = fused2._fused2_cuda(*args, True, False, False)
    ref = fused2._fused2_reference(*args, True, False, False)
    torch.cuda.synchronize()
    agree, close, k1_err, _ = compare_flagship(out[0], ref[0])
    if agree < 0.995 or close < 0.99:
        fail(f"{label}: the training kernel disagrees with its plain version")
    del ref
    logits = out[0].clone().requires_grad_(True)
    (g_logits,) = torch.autograd.grad(nll_loss(logits, y), logits)
    bargs = f2_bwd_args(args, out, g_logits.contiguous(), None, None, gamma,
                        spike)
    k2_err = check_grads(f"{label} backward",
                         lambda: fused2._fused2_bwd_cuda(*bargs),
                         lambda: fused2._fused2_bwd_reference(*bargs),
                         1e-4 if md == torch.float32 else 2.0 ** -7)
    k1_ms = cuda_ms(lambda: fused2._fused2_cuda(*args, True, False, False),
                    10)
    k2_ms = cuda_ms(lambda: fused2._fused2_bwd_cuda(*bargs), 10)
    k1_plain = cuda_ms(lambda: fused2._fused2_reference(
        *args, True, False, False), 3, 1)
    k2_plain = cuda_ms(lambda: fused2._fused2_bwd_reference(*bargs), 3, 1)
    z0, r0, ra0, m = composed_forward(args, True, False)
    zeros0 = torch.zeros((TRAIN_B, TWO_WIDTHS[0]), device="cuda")
    c_fwd = cuda_ms(lambda: composed_forward(args, True, False), 10)
    c_bwd = cuda_ms(lambda: composed_backward(
        args, z0, r0, ra0, m, g_logits, zeros0, None, gamma, spike), 10)
    del z0, r0, ra0, m

    def fwd_bwd(composed):
        """Forward and backward of the loss through the public functions,
        as a training step runs them (no optimizer)."""
        leaves = [a.clone().requires_grad_(True) if i in (1, 2, 4, 5, 7, 8)
                  else a for i, a in enumerate(args)]
        lt, w0, w0r, b0, w1, w1r, b1, w_out, b_out, T, per, alif = leaves[:12]
        sc = args[12:15]
        if composed:
            z = fused.fused_encode_rec_scan(lt, w0, w0r, b0, T, per, alif, *sc,
                                            gamma, spike)
            lg = fused_mid.fused_mid_rec_scan_head(
                z, w1, w1r, b1, w_out, b_out, T, alif, *sc, gamma, args[15],
                spike)
        else:
            lg = fused2.fused2_rec_head(*leaves[:15], gamma, args[15], spike)
        nll_loss(lg, y).backward()

    fb_ms = cuda_ms(lambda: fwd_bwd(False), 10)
    fb_comp = cuda_ms(lambda: fwd_bwd(True), 10)
    spikes0, spikes1 = twolayer_spikes(args)
    T, F, (H1, H2), O, B, it = 100, 784, TWO_WIDTHS, 10, TRAIN_B, md.itemsize
    in_spikes = input_spike_count(lat, T)
    fwd_bytes, fwd_ops, _ = twolayer_work(args, spikes0, spikes1, True, it)
    trace = T * B * (H1 + H2) * it
    grads = (F * H1 + H1 * H1 + H1 * H2 + H2 * H2 + H2 * O) * it + O * 4
    # The backward: the two residuals, latencies, g_logits, tstar and the
    # weights (but W0) read; the six gradients written.  Dense: dcur1 @
    # W1r^T, s @ W_out^T, dcur1 @ W1^T, dcur0 @ W0r^T; 0/1 products: one
    # add a selected weight; ~12 float32 operations a (row, step, unit) of
    # each chain.
    bwd_bytes = (trace + B * F * 4 + 2 * B * O * 4
                 + (H1 * H1 + H1 * H2 + H2 * H2 + H2 * O) * it + grads)
    bwd_ops = (2 * B * T * (H2 * H2 + H2 * O + H1 * H2 + H1 * H1)
               + in_spikes * H1 + spikes0 * (H1 + H2) + spikes1 * (H2 + O)
               + 12 * B * T * (H1 + H2))
    log(f"[{label}] spikes layer 0={spikes0} ({spikes0 / (B * T * H1):.4f}),"
        f" layer 1={spikes1} ({spikes1 / (B * T * H2):.4f}) of unit-steps; "
        f"K1 vs plain argmax_agree={agree:.4f} rows_within_1e-4max="
        f"{close:.4f}; K2 vs plain on K1's residuals {k2_err:.3g} of max|g|")
    log(f"[{label}] per {B}-row batch: pair {k1_ms:.4f} + {k2_ms:.4f} = "
        f"{k1_ms + k2_ms:.4f} ms; composed kernels fused_layer0_fwd + "
        f"fused_mid_fwd[head] {c_fwd:.4f} + fused_mid_bwd + fused_layer0_bwd "
        f"{c_bwd:.4f} = {c_fwd + c_bwd:.4f} ms; forward + backward of the "
        f"loss: pair {fb_ms:.4f} ms, composed {fb_comp:.4f} ms "
        f"[{card_line()}]")
    rows = [
        kernel_row(label, f"{fused.KERNEL_2_TRAIN}[{tag}]", F2_SITE,
                   launches[fused.KERNEL_2_TRAIN], k1_err, k1_ms, k1_plain,
                   fwd_bytes, fwd_ops, md),
        kernel_row(label, f"{fused.KERNEL_2_BWD}[{tag}]", F2_BWD_SITE,
                   launches[fused.KERNEL_2_BWD], k2_err, k2_ms, k2_plain,
                   bwd_bytes, bwd_ops, md)]
    del out, bargs, trainer

    if md == torch.float32:
        # The pair against the per-step loop (use_kernels=False: no kernel,
        # no two-layer code) from the same init on the same batches at the
        # flagship's lr 1e-3: the first step's gradients (gated) and ten
        # steps' losses (printed; both climb after a few steps, and a
        # near-tie spike that flips parts them).
        loop_cfg = pt.SNNConfig(**{**cfg.__dict__, "use_kernels": False})
        runs = {}
        for name, c in (("pair", cfg), ("loop", loop_cfg)):
            t = Trainer(c, seed=0, lr=1e-3, weight_decay=1e-5,
                        encode_config=enc, device="cuda")
            _, g = t.loss_and_grads(x, y)
            runs[name] = ([g[n][k] for n in g for k in g[n]],
                          [round(float(v), 3)
                           for v in timed_steps(t, batches, 10)[0]])
            del t
        loop_err = grad_error(runs["pair"][0], runs["loop"][0])
        if loop_err > 1e-4:
            fail(f"{label}: the first step's gradients differ from the "
                 f"per-step loop's by {loop_err:.3g} of max|g|")
        log(f"[{label}] lr 1e-3 from the same init: first step's gradients "
            f"vs the per-step loop {loop_err:.3g} of max|g|; losses pair="
            f"{runs['pair'][1]} loop={runs['loop'][1]}")
        del runs

    # Periodic encoding (bench.py's), for the times and the launches.
    enc_p = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
    periodic = Trainer(cfg, seed=0, lr=TWO_LR, encode_config=enc_p,
                       device="cuda")
    timed_steps(periodic, batches, 1)
    fused.reset_launch_counts()
    plosses, pseconds = timed_steps(periodic, batches, 5)
    got = fused.launch_counts()
    if launched(got) != {k: n * 5 for k, n in a_step.items()}:
        fail(f"{label}: periodic launches {got}")
    if not all(np.isfinite([float(v) for v in plosses])):
        fail(f"{label}: non-finite loss with periodic encoding")
    log(f"[{label}] periodic 5 steps of {TRAIN_B}: "
        f"{pseconds / 5 * 1e3:.3f} ms a step = "
        f"{TRAIN_B * 5 / pseconds:.1f} img/s [{card_line()}]")
    del periodic

    # A count regularizer takes the _counts variant: both layers' counts
    # come from the pair.
    reg = Trainer(cfg, seed=0, lr=TWO_LR,
                  reg_fn=L2SpikesPerNeuron(scale=1e-9), encode_config=enc,
                  device="cuda")
    fused.reset_launch_counts()
    rlosses, rseconds = timed_steps(reg, batches, 3)
    got = fused.launch_counts()
    if launched(got) != {k: n * 3 for k, n in a_step.items()}:
        fail(f"{label}: count-regularized launches {got}")
    if not all(np.isfinite([float(v) for v in rlosses])):
        fail(f"{label}: non-finite count-regularized loss")
    log(f"[{label}] L2SpikesPerNeuron 3 steps: {rseconds / 3 * 1e3:.3f} ms a "
        f"step (first step included); launches={json.dumps(launched(got))} "
        f"losses={[round(float(v), 4) for v in rlosses]}")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 14-16: wide recurrent layers (784-ALIF512-10) on the unfused tier
# ---------------------------------------------------------------------------
WIDE_H = 512
WIDE_TIMED = 20
ENC_SITE = ("encode_matmul.cu", "pallas_encode.py:165")
ENC_BWD_SITE = ("encode_matmul.cu", "pallas_encode.py:209")
REC_SITE = ("rec_scan.cu", "pallas_rec.py:184")
REC_BWD_SITE = ("rec_scan.cu", "pallas_rec.py:314")


def wide_bar(T, md, full=False):
    """A backward against its plain version on the same residuals, of
    max|g|: float32 2e-6 small (5e-6 at T = 100), 1e-4 at full width;
    bfloat16 one rounding, 2**-7."""
    if md == torch.bfloat16:
        return 2.0 ** -7
    return 1e-4 if full else (2e-6 if T < 100 else 5e-6)


def rec_inputs(rng, B, H, T, md):
    """Currents 0.3 + 0.6 N(0, 1) and a masked W_rec of std 1.3 / sqrt(H)
    (10-20 % of unit-steps fire, a tenth of them pushed by the
    recurrence)."""
    cur = torch.from_numpy((0.3 + 0.6 * rng.standard_normal((T, B, H)))
                           .astype(np.float32)).cuda()
    w = rand_w(rng, (H, H), 1.3 / np.sqrt(H)) * (1 - torch.eye(H,
                                                               device="cuda"))
    return cur, w.to(md)


def check_encode(label, rng, B, F, H, T, per, md, full):
    """``encode_matmul_fwd`` against its plain version (currents within
    1e-5 of max|current|: up to F terms of either sign summed in another
    order, so the error scales with their absolute sum, not with the
    current) and ``encode_matmul_bwd`` on a random cotangent (``wide_bar``;
    equal bits twice).  Returns the two errors."""
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    w = rand_w(rng, (F, H), 0.5, md)
    got = encode._fwd_cuda(lat, w, T, per)
    want = encode._fwd_reference(lat, w, T, per)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-5 * float(want.abs().max()):
        fail(f"{label}: encoded currents differ by {err:.3g}")
    del got, want
    g = rand_w(rng, (T, B, H), 1.0)
    gerr = check_grads(f"{label} backward",
                       lambda: (encode._bwd_cuda(lat, g, md, T, per),),
                       lambda: (encode._bwd_reference(lat, g, md, T, per),),
                       wide_bar(T, md, full))
    return err, gerr


def check_rec(label, rng, B, H, T, alif, spike, md, full):
    """``rec_scan_fwd[_train]`` against the plain version fed the same
    currents: inference spikes the training kernel's bit for bit, spikes
    equal on every row small (>= 99.5 % of rows at full width, where a
    near-tie flip between two float32 summation orders takes its row's trace
    with it), residuals 1e-5 (bf16 2**-7) on the equal rows;
    ``rec_scan_bwd`` on the training kernel's residuals (``wide_bar``,
    equal bits twice).  Returns (share of equal rows, residual error,
    gradient error)."""
    f32 = md == torch.float32
    alpha, rho, thr, gamma = layer_scalars(alif)
    beta = 1.6 if alif else 0.0
    store_a = alif and spike == PHI
    res_is_v = fused._residual_is_v(alif, spike)
    cur, w = rec_inputs(rng, B, H, T, md)
    fwd = (cur, w, beta, alif, alpha, rho, thr)
    z, res, a_tr = rec_scan._fwd_cuda(*fwd, True, store_a, res_is_v)
    z_inf = rec_scan._fwd_cuda(*fwd, False, False, False)[0]
    zp, resp, ap = rec_scan._fwd_reference(*fwd, True, store_a, res_is_v)
    torch.cuda.synchronize()
    if not torch.equal(z, z_inf):
        fail(f"{label}: inference and training spikes differ")
    same = (z == zp).all(dim=2).all(dim=0)
    share = float(same.float().mean())
    rate = float(z.float().mean())
    if not 0.02 < rate < 0.6:
        fail(f"{label}: firing rate {rate:.3f} out of range")
    if share < (0.995 if full else 1.0):
        fail(f"{label}: spikes equal on {share:.4f} of rows")
    res_err = 0.0
    tol = 1e-5 if f32 else 2.0 ** -7
    for got, want in ((res, resp), (a_tr, ap)):
        if (got is None) != (want is None):
            fail(f"{label}: residual set differs")
        if got is None:
            continue
        g_, w_ = got[:, same].float(), want[:, same].float()
        res_err = max(res_err, float((g_ - w_).abs().max()))
        if not torch.allclose(g_, w_, atol=tol, rtol=tol):
            fail(f"{label}: residuals differ by {res_err:.3g}")
    del zp, resp, ap, z_inf, cur
    g_z = rand_w(rng, (T, B, H), 1.0 / B, md)
    bw = (g_z, z, res, a_tr, res_is_v, w, beta, alpha, thr, gamma, spike)
    gerr = check_grads(f"{label} backward",
                       lambda: rec_scan._bwd_cuda(*bw),
                       lambda: rec_scan._bwd_reference(*bw),
                       wide_bar(T, md, full))
    return share, res_err, gerr


def phase_wide_kernels() -> None:
    """Phase 14: ``encode_matmul_fwd/bwd`` and ``rec_scan_fwd[_train]/bwd``
    against their plain versions: small shapes at T = 24 and 100 (TTFS and
    periodic; LIF/ALIF x FastSigmoid/Phi; f32 and bf16), full width
    (B = 8192, 784 -> 512, T = 100) and H = 1024 on a small batch."""
    rng = np.random.default_rng(14)
    worst = {"enc": 0.0, "enc_g": 0.0, "rec_g": 0.0, "rows": 1.0}
    n = 0
    for md in (torch.float32, torch.bfloat16):
        tag = "f32" if md == torch.float32 else "bf16"
        for T in (24, 100):
            for per in (False, True):
                e, g = check_encode(f"wide-kernels encode {tag} T={T} "
                                    f"per={per}", rng, 9, 30, 40, T, per, md,
                                    False)
                worst["enc"], worst["enc_g"] = (max(worst["enc"], e),
                                                max(worst["enc_g"], g))
                n += 1
            for name, alif, rec, spike in DEEP_CASES:
                if not rec:
                    continue
                for H in (20, 40):
                    _, _, g = check_rec(f"wide-kernels rec {name} {tag} "
                                        f"T={T} H={H}", rng, 37, H, T, alif,
                                        spike, md, False)
                    worst["rec_g"] = max(worst["rec_g"], g)
                    n += 1
    log(f"[wide-kernels] {n} small cases ok: encode currents <= "
        f"{worst['enc']:.3g}, encode g_W <= {worst['enc_g']:.3g}, rec "
        f"gradients <= {worst['rec_g']:.3g} of max|g|")
    for md in (torch.float32, torch.bfloat16):
        tag = "f32" if md == torch.float32 else "bf16"
        for per in (False, True):
            e, g = check_encode(f"wide-kernels encode full {tag} per={per}",
                                rng, TRAIN_B, 784, WIDE_H, 100, per, md,
                                True)
            log(f"[wide-kernels] encode B={TRAIN_B} 784->{WIDE_H} T=100 "
                f"{tag} periodic={per}: currents err {e:.3g}, g_W err "
                f"{g:.3g} of max|g|")
            torch.cuda.empty_cache()
        for B, H in ((TRAIN_B, WIDE_H), (256, 1024)):
            share, r, g = check_rec(f"wide-kernels rec B={B} H={H} {tag}",
                                    rng, B, H, 100, True, FS, md, True)
            log(f"[wide-kernels] rec ALIF FastSigmoid B={B} H={H} T=100 "
                f"{tag}: spikes equal on {share:.4f} of rows, residuals err "
                f"{r:.3g}, gradients err {g:.3g} of max|g|")
            torch.cuda.empty_cache()
        e, g = check_encode(f"wide-kernels encode H=1024 {tag}", rng, 256,
                            784, 1024, 100, True, md, True)
        log(f"[wide-kernels] encode B=256 784->1024 T=100 {tag}: currents "
            f"err {e:.3g}, g_W err {g:.3g} of max|g|")


def wide_cfg(matmul_dtype, use_kernels=True):
    """784 -> ALIF-512 (recurrent, learn_beta) -> 10, T = 100: the widest
    width of scripts/wide_hidden_check.py."""
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=WIDE_H,
        hidden_layer_type=pt.LayerType.ALIF, use_recurrent_connection=True,
        learn_beta=True, int_time_steps=100, matmul_dtype=matmul_dtype,
        use_kernels=use_kernels)


def wide_args(cfg, params):
    """The layer's weights and scalars as the dispatch passes them."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    (n0, c0), _ = cfg.layer_configs
    p0 = params[n0]
    return (p0["w_in"].detach().to(md).contiguous(),
            masked_recurrent(c0, p0).detach().to(md).contiguous(),
            p0["beta"].detach(), c0)


def raster(lat, T, per, md):
    """The (T B, F) spike raster, for the library call's time only."""
    return torch.stack([spike_row(lat, t, T, per).to(md)
                        for t in range(T)]).reshape(-1, lat.shape[1])


def encode_work(lat, T, H, per, itemsize):
    """(bytes, operations, input spikes) of either encoded-product kernel:
    the latencies and W (forward) or the cotangent (backward) read once,
    the currents or g_W written once; one add per input spike and unit."""
    B, F = lat.shape
    in_spikes = input_spike_count(lat, T, per)
    return (B * F * 4 + F * H * itemsize + T * B * H * 4, in_spikes * H,
            in_spikes)


def rec_work(B, H, T, z, itemsize, n_res, backward):
    """(bytes, operations) of the scan on these inputs.  Forward: the
    currents and W_rec read, z (and ``n_res`` residual traces) written; one
    add per set bit of z(t-1) and unit, ~10 operations a (row, step, unit).
    Backward: g_z, z and the residuals read, g_i and g_W_rec written;
    dcur @ W_rec^T dense (2 B T H^2), one add per set bit for g_W_rec, ~12
    operations a (row, step, unit)."""
    trace = T * B * H * itemsize
    spikes = int(z[:-1].float().sum())
    w = H * H * itemsize
    if not backward:
        return (T * B * H * 4 + w + 4 + trace * (1 + n_res),
                spikes * H + 10 * B * T * H)
    return (trace * (2 + n_res) + w + T * B * H * 4 + w,
            2 * B * T * H * H + spikes * H + 12 * B * T * H)


def phase_wide_serve(matmul_dtype: str) -> list:
    """Phase 15: 784-ALIF512-10 served as in phase 4 at batch 4096: results
    bitwise a direct forward, one ``encode_matmul_fwd`` and one
    ``rec_scan_fwd`` launch a batch and no training kernel; on a served
    batch the logits within 1e-4 of max|logit| on >= 99 % of rows of the
    plain versions' composition; each kernel alone, timed, with its bound
    and plain time (and cuBLAS on the raster for the encoded product)."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"wide-serve {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = wide_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(cfg, enc)]
    if paths != [f"cuda:{fused.KERNEL_ENC}", f"cuda:{fused.KERNEL_REC}",
                 "torch:loop"]:
        fail(f"{label}: dispatch is {paths}")
    reqs, launches = serve_requests(label, cfg, params, enc,
                                    {fused.KERNEL_ENC: 1, fused.KERNEL_REC: 1})
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    w0, wr, beta, c0 = wide_args(cfg, params)
    T, B, H = 100, lat.shape[0], WIDE_H
    sc = (beta, True, c0.alpha, c0.rho, c0.threshold)
    cur = encode._fwd_cuda(lat, w0, T, False)
    cur_p = encode._fwd_reference(lat, w0, T, False)
    z = rec_scan._fwd_cuda(cur, wr, *sc, False, False, False)[0]
    zp = rec_scan._fwd_reference(cur_p, wr, *sc, False, False, False)[0]
    torch.cuda.synchronize()
    enc_err = float((cur - cur_p).abs().max())
    rows = float((z == zp).all(dim=2).all(dim=0).float().mean())
    with torch.no_grad():
        logits = model_lib.forward_logits_pixels(cfg, params, x, enc,
                                                 device="cuda")
        trace, _ = model_lib.apply(cfg, params, None, first_layer_output=zp,
                                   device="cuda")
        plain_logits = model_lib.prediction_logits(cfg, trace)
    agree, close, lerr, scale = compare_flagship(logits, plain_logits)
    rate = float(z.float().mean())
    log(f"[{label}] served batch: currents vs plain {enc_err:.3g}; hidden "
        f"spikes equal on {rows:.4f} of rows ({rate:.4f} of unit-steps "
        f"fire); logits vs the plain versions' composition argmax_agree="
        f"{agree:.4f} rows_within_1e-4max={close:.4f} max_abs_err={lerr:.3g}"
        f" max|logit|={scale:.3g}")
    if rows < 0.995 or close < 0.99 or agree < 0.995:
        fail(f"{label}: the kernels disagree with their plain versions")
    del cur_p, zp, trace
    enc_ms = cuda_ms(lambda: encode._fwd_cuda(lat, w0, T, False), 25)
    enc_plain = cuda_ms(lambda: encode._fwd_reference(lat, w0, T, False), 5,
                        warmup=1)
    spikes_in = raster(lat, T, False, md)
    enc_lib = cuda_ms(lambda: spikes_in @ w0, 25)
    del spikes_in
    rec_ms = cuda_ms(lambda: rec_scan._fwd_cuda(cur, wr, *sc, False, False,
                                                False), 10)
    rec_plain = cuda_ms(lambda: rec_scan._fwd_reference(
        cur, wr, *sc, False, False, False), 3, warmup=1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model_lib.forward_logits_pixels(
            cfg, params, x, enc, device="cuda"), 5)
    eb, eo, in_spikes = encode_work(lat, T, H, False, md.itemsize)
    rb, ro = rec_work(B, H, T, z, md.itemsize, 0, False)
    log(f"[{label}] per 4096-row batch: forward_logits_pixels {fwd_ms:.4f} "
        f"ms = {B / fwd_ms * 1e3:.1f} img/s, of it {fused.KERNEL_ENC} "
        f"{enc_ms:.4f} + {fused.KERNEL_REC} {rec_ms:.4f} ms, the rest the "
        f"readout's per-step loop; input spikes={in_spikes} [{card_line()}]")
    rows_out = [
        kernel_row(label, f"{fused.KERNEL_ENC}[{tag}]", ENC_SITE,
                   launches[fused.KERNEL_ENC], enc_err, enc_ms, enc_plain,
                   eb, eo, md, library_ms=enc_lib),
        # Its error: the served logits' against the plain versions'
        # composition on the same batch (the spikes are 0/1).
        kernel_row(label, f"{fused.KERNEL_REC}[{tag}]", REC_SITE,
                   launches[fused.KERNEL_REC], lerr, rec_ms, rec_plain, rb,
                   ro, md)]
    torch.cuda.empty_cache()
    return rows_out


def phase_wide_train(matmul_dtype: str) -> list:
    """Phase 16: 784-ALIF512-10 through ``Trainer`` at batch 8192: 3
    warm-up and WIDE_TIMED timed TTFS steps (finite falling loss, beta
    bitwise, every trained leaf moves, one launch a step of each of
    ``encode_matmul_fwd``, ``rec_scan_fwd_train``, ``rec_scan_bwd`` and
    ``encode_matmul_bwd``); the first step's gradients against the per-step
    loop's (``use_kernels=False``; gated 1e-4 of max|g| in f32); batch 0's
    logits against the plain versions' composition (>= 99.5 % argmax, >= 99 %
    of rows within 1e-4 of max|logit|); each kernel alone on batch 0 with
    the trained weights against its plain version
    (the backwards on the forward kernels' outputs), timed, with its bound,
    plain time and, for the encoded product, cuBLAS on the raster; then 5
    periodic steps (times and launches)."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"wide-train {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = wide_cfg(matmul_dtype)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, device="cuda", training=True)]
    if paths != [f"cuda:{fused.KERNEL_ENC}+{fused.KERNEL_ENC_BWD}",
                 f"cuda:{fused.KERNEL_REC_TRAIN}+{fused.KERNEL_REC_BWD}",
                 "torch:loop"]:
        fail(f"{label}: dispatch is {paths}")
    batches = synthetic_task(4)
    x, y = batches[0]

    # The first step's gradients against the per-step loop's, same init.
    grads = {}
    for name, c in (("kernels", cfg), ("loop", wide_cfg(matmul_dtype,
                                                        False))):
        t = Trainer(c, seed=0, encode_config=enc, device="cuda")
        _, g = t.loss_and_grads(x, y)
        grads[name] = [g[n][k] for n in g for k in g[n]]
        del t, g
    loop_err = grad_error(grads["kernels"], grads["loop"])
    del grads
    torch.cuda.empty_cache()
    log(f"[{label}] first step's gradients vs the per-step loop: "
        f"{loop_err:.3g} of max|g|")
    if md == torch.float32 and loop_err > 1e-4:
        fail(f"{label}: the first step's gradients differ from the loop's")

    trainer = Trainer(cfg, seed=0, lr=1e-3, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    a_step = {fused.KERNEL_ENC: 1, fused.KERNEL_REC_TRAIN: 1,
              fused.KERNEL_REC_BWD: 1, fused.KERNEL_ENC_BWD: 1}
    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, WIDE_TIMED, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    log(f"[{label}] ttfs losses={[round(v, 3) for v in losses]}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {k: n * WIDE_TIMED for k, n in a_step.items()}:
        fail(f"{label}: launches {launches} in {WIDE_TIMED} steps")
    for n, g in trainer.params.items():
        for k, v in g.items():
            same = torch.equal(v, before[n][k])
            if k == "beta" and not same:
                fail(f"{label}: beta moved")
            if k != "beta" and same:
                fail(f"{label}: {n}.{k} did not change")
    step_ms = seconds / WIDE_TIMED * 1e3
    log(f"[{label}] ttfs {WIDE_TIMED} steps of {TRAIN_B}: {step_ms:.3f} ms a "
        f"step = {TRAIN_B * WIDE_TIMED / seconds:.1f} img/s; loss first5="
        f"{first:.4f} last5={last:.4f}; launches="
        f"{json.dumps(launched(launches))} [{card_line()}]")

    # Each kernel alone on batch 0 with the trained weights.
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    w0, wr, beta, c0 = wide_args(cfg, trainer.params)
    T, B, H, F = 100, TRAIN_B, WIDE_H, 784
    sc = (beta, True, c0.alpha, c0.rho, c0.threshold)
    res_is_v = fused._residual_is_v(True, c0.spike_func)
    cur = encode._fwd_cuda(lat, w0, T, False)
    enc_err = float((cur - encode._fwd_reference(lat, w0, T, False))
                    .abs().max())
    z, res, a_tr = rec_scan._fwd_cuda(cur, wr, *sc, True, False, res_is_v)
    zp, resp, _ = rec_scan._fwd_reference(cur, wr, *sc, True, False,
                                          res_is_v)
    same = (z == zp).all(dim=2).all(dim=0)
    rows = float(same.float().mean())
    res_err = float((res[:, same].float() - resp[:, same].float())
                    .abs().max())
    del zp, resp
    if rows < 0.995:
        fail(f"{label}: spikes equal on {rows:.4f} of rows")
    # The whole forward at B = 8192 against the plain versions' composition.
    with torch.no_grad():
        logits = model_lib.forward_logits_pixels(cfg, trainer.params, x, enc,
                                                 device="cuda")
        zq = rec_scan._fwd_reference(encode._fwd_reference(lat, w0, T, False),
                                     wr, *sc, False, False, False)[0]
        trace, _ = model_lib.apply(cfg, trainer.params, None,
                                   first_layer_output=zq, device="cuda")
        agree, close, lerr, _ = compare_flagship(
            logits, model_lib.prediction_logits(cfg, trace))
    del zq, trace, logits
    if agree < 0.995 or close < 0.99:
        fail(f"{label}: logits disagree with the plain versions' "
             f"composition ({agree:.4f}, {close:.4f})")
    g_z = rand_w(np.random.default_rng(16), (T, B, H), 1.0 / B, md)
    bw = (g_z, z, res, a_tr, res_is_v, wr, beta, c0.alpha, c0.threshold,
          c0.gamma, c0.spike_func)
    rec_g_err = check_grads(f"{label} rec backward",
                            lambda: rec_scan._bwd_cuda(*bw),
                            lambda: rec_scan._bwd_reference(*bw),
                            wide_bar(T, md, True))
    g_cur = rec_scan._bwd_cuda(*bw)[0]
    enc_g_err = check_grads(
        f"{label} encode backward",
        lambda: (encode._bwd_cuda(lat, g_cur, md, T, False),),
        lambda: (encode._bwd_reference(lat, g_cur, md, T, False),),
        wide_bar(T, md, True))
    log(f"[{label}] kernels alone on batch 0: currents err {enc_err:.3g}; "
        f"spikes equal on {rows:.4f} of rows, residual err {res_err:.3g}; "
        f"logits vs the plain versions' composition argmax_agree={agree:.4f}"
        f" rows_within_1e-4max={close:.4f} max_abs_err={lerr:.3g}; "
        f"rec_scan_bwd {rec_g_err:.3g}, encode_matmul_bwd {enc_g_err:.3g} "
        f"of max|g| ({float(z.float().mean()):.4f} of unit-steps fire)")
    t_ef = cuda_ms(lambda: encode._fwd_cuda(lat, w0, T, False), 10)
    t_ef_p = cuda_ms(lambda: encode._fwd_reference(lat, w0, T, False), 3, 1)
    t_rf = cuda_ms(lambda: rec_scan._fwd_cuda(cur, wr, *sc, True, False,
                                              res_is_v), 5)
    t_rf_p = cuda_ms(lambda: rec_scan._fwd_reference(
        cur, wr, *sc, True, False, res_is_v), 3, 1)
    t_rb = cuda_ms(lambda: rec_scan._bwd_cuda(*bw), 5)
    t_rb_p = cuda_ms(lambda: rec_scan._bwd_reference(*bw), 3, 1)
    t_eb = cuda_ms(lambda: encode._bwd_cuda(lat, g_cur, md, T, False), 10)
    t_eb_p = cuda_ms(lambda: encode._bwd_reference(lat, g_cur, md, T,
                                                   False), 3, 1)
    spikes_in = raster(lat, T, False, md)
    lib_f = cuda_ms(lambda: spikes_in @ w0, 10)
    g_flat = g_cur.reshape(T * B, H).to(md)
    lib_b = cuda_ms(lambda: spikes_in.T @ g_flat, 10)
    del spikes_in, g_flat
    eb, eo, _ = encode_work(lat, T, H, False, md.itemsize)
    rfb, rfo = rec_work(B, H, T, z, md.itemsize, 1, False)
    rbb, rbo = rec_work(B, H, T, z, md.itemsize, 1, True)
    out = [
        kernel_row(label, f"{fused.KERNEL_ENC}[train-{tag}]", ENC_SITE,
                   launches[fused.KERNEL_ENC], enc_err, t_ef, t_ef_p, eb, eo,
                   md, library_ms=lib_f),
        kernel_row(label, f"{fused.KERNEL_REC_TRAIN}[{tag}]", REC_SITE,
                   launches[fused.KERNEL_REC_TRAIN], res_err, t_rf, t_rf_p,
                   rfb, rfo, md),
        kernel_row(label, f"{fused.KERNEL_REC_BWD}[{tag}]", REC_BWD_SITE,
                   launches[fused.KERNEL_REC_BWD], rec_g_err, t_rb, t_rb_p,
                   rbb, rbo, md),
        kernel_row(label, f"{fused.KERNEL_ENC_BWD}[{tag}]", ENC_BWD_SITE,
                   launches[fused.KERNEL_ENC_BWD], enc_g_err, t_eb, t_eb_p,
                   eb, eo, md, library_ms=lib_b)]
    del cur, z, res, a_tr, g_z, bw, g_cur, trainer
    torch.cuda.empty_cache()

    # Periodic encoding, for the times and the launches.
    enc_p = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
    periodic = Trainer(cfg, seed=0, encode_config=enc_p, device="cuda")
    timed_steps(periodic, batches, 1)
    fused.reset_launch_counts()
    plosses, pseconds = timed_steps(periodic, batches, 5)
    got = fused.launch_counts()
    if launched(got) != {k: n * 5 for k, n in a_step.items()}:
        fail(f"{label}: periodic launches {got}")
    if not all(np.isfinite([float(v) for v in plosses])):
        fail(f"{label}: non-finite loss with periodic encoding")
    log(f"[{label}] periodic 5 steps of {TRAIN_B}: "
        f"{pseconds / 5 * 1e3:.3f} ms a step = "
        f"{TRAIN_B * 5 / pseconds:.1f} img/s [{card_line()}]")
    del periodic
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 17-19: feedforward layers on the feedforward scan (784-ALIF256-10,
# 784-LIF128-10) with constant-pixel input
# ---------------------------------------------------------------------------
FF_TIMED = 20
SCAN_SITE = ("scan.cu", "pallas_scan.py:280")
SCAN_BWD_SITE = ("scan.cu", "pallas_scan.py:314")
# scripts/run_baseline_configs.py: config #3's network (784 -> ALIF-256 ->
# 10, :70-77) and config #1's (784 -> LIF-128 -> 10, :54-61), both
# feedforward, T = 100, FastSigmoid, learn_beta=False.
FF_NETS = {"ff-a": (pt.LayerType.ALIF, 256), "ff-l": (pt.LayerType.LIF, 128)}
SCAN_CASES = [("alif-fs", True, FS), ("alif-phi", True, PHI),
              ("lif-fs", False, FS), ("lif-phi", False, PHI)]


def ff_cfg(net, matmul_dtype, use_kernels=True):
    kind, hidden = FF_NETS[net]
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=hidden,
        hidden_layer_type=kind, use_recurrent_connection=False,
        learn_beta=False, int_time_steps=100, matmul_dtype=matmul_dtype,
        use_kernels=use_kernels)


def cuda_randn(shape, seed, mean=0.0, std=1.0, dtype=torch.float32):
    """mean + std N(0, 1) drawn on the card (a (T, B, H) trace at B = 8192
    takes seconds to draw with numpy)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (mean + std * torch.randn(shape, generator=g, device="cuda")
            ).to(dtype)


def ff_layer_args(cfg, params):
    """(beta, alif, alpha, rho, threshold) of layer 0 as the dispatch
    passes them (the scan wrappers' order), and its config."""
    (n0, c0), _ = cfg.layer_configs
    alif, beta, rho = model_lib._beta_rho(c0, params[n0])
    return (beta, alif, c0.alpha, rho, c0.threshold), c0


def ff_currents(cfg, params, x):
    """Layer 0's currents (T, B, H) as ``apply`` computes them for
    constant-pixel input: the pixels repeated over T (``format_inputs``),
    one product in the matmul dtype with float32 sums."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    xs = model_lib.format_inputs(cfg, x)
    w = params[cfg.layer_configs[0][0]]["w_in"].detach()
    if md == torch.float32:
        cur = xs @ w
    else:
        cur = xs.to(md).to(torch.float32) @ w.to(md).to(torch.float32)
    return cur.transpose(0, 1).contiguous()


def scan_work(T, B, H, itemsize, n_res, backward):
    """(bytes, operations) of a scan kernel: forward the currents read
    (float32) and z and ``n_res`` residual traces written, ~10 operations
    a (row, step, unit); backward g_z, z and the residuals read, g_i
    (float32) written, ~12 operations a (row, step, unit)."""
    n = T * B * H
    if backward:
        return n * (itemsize * (2 + n_res) + 4) + 4, 12 * n
    return n * (4 + itemsize * (1 + n_res)) + 4, 10 * n


def scan_bar(spike):
    """``scan_bwd`` against its plain version on the same residuals, of
    max|g|, at any shape and trace dtype (both read the same stored values
    and compute in float32): FastSigmoid 0, bit for bit, since both round
    the same operations in the same order; Phi 2e-6, the one-ulp
    differences of the two ``exp``s (measured <= 1.9e-7 on the H100)."""
    return 0.0 if spike == FS else 2e-6


def check_scan(label, B, H, T, alif, spike, md, full, beta_tensor, seed):
    """``scan_fwd[_train]`` against the plain version fed the same currents
    (0.3 + 0.6 N(0, 1)): inference spikes the training kernel's bit for
    bit, spikes equal on every row small (>= 99.5 % of rows at full
    width), residuals 1e-5 (bf16 2**-7) on the equal rows; ``scan_bwd`` on
    the training kernel's residuals (``scan_bar``, equal bits twice).
    Returns (share of equal rows, residual error, gradient error, firing
    share)."""
    alpha, rho, thr, gamma = layer_scalars(alif)
    beta = 1.6 if alif else 0.0
    if beta_tensor:
        beta = torch.tensor(beta, device="cuda")
    store_a = fused._stores_a(alif, spike)
    res_is_v = fused._residual_is_v(alif, spike)
    cur = cuda_randn((T, B, H), seed, 0.3, 0.6)
    fwd = (cur, beta, alif, alpha, rho, thr)
    z, res, a_tr = scan._fwd_cuda(*fwd, True, store_a, res_is_v, md)
    z_inf = scan._fwd_cuda(*fwd, False, False, False, md)[0]
    zp, resp, ap = scan._fwd_reference(*fwd, True, store_a, res_is_v, md)
    torch.cuda.synchronize()
    if not torch.equal(z, z_inf):
        fail(f"{label}: inference and training spikes differ")
    same = (z == zp).all(dim=2).all(dim=0)
    share = float(same.float().mean())
    rate = float(z.float().mean())
    if not 0.02 < rate < 0.6:
        fail(f"{label}: firing rate {rate:.3f} out of range")
    if share < (0.995 if full else 1.0):
        fail(f"{label}: spikes equal on {share:.4f} of rows")
    res_err = 0.0
    tol = 1e-5 if md == torch.float32 else 2.0 ** -7
    for got, want in ((res, resp), (a_tr, ap)):
        if (got is None) != (want is None):
            fail(f"{label}: residual set differs")
        if got is None:
            continue
        g_, w_ = got[:, same].float(), want[:, same].float()
        res_err = max(res_err, float((g_ - w_).abs().max()))
        if not torch.allclose(g_, w_, atol=tol, rtol=tol):
            fail(f"{label}: residuals differ by {res_err:.3g}")
    del zp, resp, ap, z_inf, cur
    g_z = cuda_randn((T, B, H), seed + 1, std=1.0 / B, dtype=md)
    bw = (g_z, z, res, a_tr, res_is_v, beta, alpha, thr, gamma, spike)
    gerr = check_grads(f"{label} backward",
                       lambda: (scan._bwd_cuda(*bw),),
                       lambda: (scan._bwd_reference(*bw),),
                       scan_bar(spike))
    return share, res_err, gerr, rate


def ff_layer0_cross_check(md) -> None:
    """Layer 0 of 784-ALIF256-10 (784-LIF128-10 where ``fused_supported``
    refuses 784 -> 256) on the same latencies and weights through
    ``encode_matmul_fwd`` + ``scan_fwd`` and through ``fused_layer0_fwd``:
    both sum W_in's rows of the set inputs in ascending order and step
    ``LifCell``, so their spikes agree; gated at >= 99.5 % of rows, TTFS
    and periodic, B = 8192."""
    tag = "f32" if md == torch.float32 else "bf16"
    for net in FF_NETS:
        if fused.fused_supported(100, 784, FF_NETS[net][1], recurrent=False,
                                 itemsize=md.itemsize, device="cuda"):
            break
    else:
        fail("scan-kernels: fused_layer0_fwd takes neither feedforward net")
    cfg = ff_cfg(net, "float32" if md == torch.float32 else "bfloat16")
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    (beta, alif, alpha, rho, thr), _ = ff_layer_args(cfg, params)
    w0 = params["input"]["w_in"].to(md).contiguous()
    x = synthetic_task(1)[0][0]
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    for per in (False, True):
        cur = encode._fwd_cuda(lat, w0, 100, per)
        z = scan._fwd_cuda(cur, beta, alif, alpha, rho, thr, False, False,
                           False, md)[0]
        z0 = fused._layer0_cuda(lat, w0, None, beta, 100, per, alif, alpha,
                                rho, thr, False, False, False)[0]
        torch.cuda.synchronize()
        share, rate = rows_equal(z, z0), float(z0.float().mean())
        log(f"[scan-kernels] {net} layer 0 {tag} periodic={per}: "
            f"encode_matmul_fwd + scan_fwd against fused_layer0_fwd, spikes "
            f"equal on {share:.4f} of rows ({rate:.4f} of unit-steps fire)")
        if share < 0.995:
            fail(f"scan-kernels: {net} layer 0 {tag} periodic={per}: the "
                 f"composed kernels disagree with fused_layer0_fwd")
        del cur, z, z0
    torch.cuda.empty_cache()


def phase_scan_kernels() -> None:
    """Phase 17: ``scan_fwd[_train]`` and ``scan_bwd`` against their plain
    versions: LIF/ALIF x FastSigmoid/Phi, T = 23, 24 and 100, B = 37 with
    H = 19 (beta a float) and 45 (beta a device tensor), f32 and bf16; at
    B = 8192, T = 100: ALIF FastSigmoid H = 256, LIF H = 128, ALIF Phi
    H = 512 (f32 and bf16) and ALIF H = 1024 (f32); then layer 0 of the
    feedforward nets through ``encode_matmul_fwd`` + ``scan_fwd`` against
    ``fused_layer0_fwd``."""
    worst = {"res": 0.0, "g": 0.0}
    n, seed = 0, 170
    for md in (torch.float32, torch.bfloat16):
        tag = "f32" if md == torch.float32 else "bf16"
        for T in (23, 24, 100):
            for name, alif, spike in SCAN_CASES:
                for H, bt in ((19, False), (45, True)):
                    seed += 2
                    _, r, g, _ = check_scan(
                        f"scan-kernels {name} {tag} T={T} H={H}", 37, H, T,
                        alif, spike, md, False, bt, seed)
                    worst["res"], worst["g"] = (max(worst["res"], r),
                                                max(worst["g"], g))
                    n += 1
    log(f"[scan-kernels] {n} small cases ok: spikes equal, residuals <= "
        f"{worst['res']:.3g}, gradients <= {worst['g']:.3g} of max|g|")
    full = [(torch.float32, True, FS, 256, False),
            (torch.float32, False, FS, 128, False),
            (torch.float32, True, PHI, 512, True),
            (torch.bfloat16, True, FS, 256, False),
            (torch.bfloat16, False, FS, 128, False),
            (torch.bfloat16, True, PHI, 512, True),
            (torch.float32, True, FS, 1024, False)]
    for md, alif, spike, H, bt in full:
        tag = "f32" if md == torch.float32 else "bf16"
        what = (f"{'ALIF' if alif else 'LIF'} "
                f"{'FastSigmoid' if spike == FS else 'Phi'} B={TRAIN_B} "
                f"H={H} T=100 {tag}")
        seed += 2
        share, r, g, rate = check_scan(f"scan-kernels {what}", TRAIN_B, H,
                                       100, alif, spike, md, True, bt, seed)
        log(f"[scan-kernels] {what}: spikes equal on {share:.4f} of rows, "
            f"residuals err {r:.3g}, gradients err {g:.3g} of max|g| "
            f"({rate:.4f} of unit-steps fire)")
        torch.cuda.empty_cache()
    for md in (torch.float32, torch.bfloat16):
        ff_layer0_cross_check(md)


def phase_ff_serve(net: str, matmul_dtype: str) -> list:
    """Phase 18: a feedforward net with constant-pixel input
    (``as_timeseries=False``) served as in phase 4 at batch 4096: results
    bitwise a direct forward, one ``scan_fwd`` launch a batch and no other
    kernel (the readout's per-step loop stays); on a served batch the
    spikes equal the plain version's on >= 99.5 % of rows and the logits
    of the plain version's composition within 1e-4 of max|logit| on >= 99
    %; the kernel alone timed beside its plain version; for 784-LIF128-10
    also ``forward_logits`` on a TTFS spike raster (4096, 100, 784), one
    ``scan_fwd`` launch."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"ff-serve {net} {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = ff_cfg(net, matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps, as_timeseries=False)
    paths = [r["path"] for r in model_lib.explain_dispatch(cfg, enc)]
    if paths != [f"cuda:{fused.KERNEL_SCAN}", "torch:loop"]:
        fail(f"{label}: dispatch is {paths}")
    reqs, launches = serve_requests(label, cfg, params, enc,
                                    {fused.KERNEL_SCAN: 1})
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    sc, _ = ff_layer_args(cfg, params)
    cur = ff_currents(cfg, params, x)
    T, B, H = cur.shape
    z = scan._fwd_cuda(cur, *sc, False, False, False, md)[0]
    zp = scan._fwd_reference(cur, *sc, False, False, False, md)[0]
    torch.cuda.synchronize()
    rows = rows_equal(z, zp)
    rate = float(z.float().mean())
    with torch.no_grad():
        logits = model_lib.forward_logits_pixels(cfg, params, x, enc,
                                                 device="cuda")
        trace, _ = model_lib.apply(cfg, params, None, first_layer_output=zp,
                                   device="cuda")
        plain_logits = model_lib.prediction_logits(cfg, trace)
    agree, close, lerr, scale = compare_flagship(logits, plain_logits)
    log(f"[{label}] served batch: hidden spikes equal the plain version's on "
        f"{rows:.4f} of rows ({rate:.4f} of unit-steps fire); logits vs the "
        f"plain version's composition argmax_agree={agree:.4f} "
        f"rows_within_1e-4max={close:.4f} max_abs_err={lerr:.3g} "
        f"max|logit|={scale:.3g}")
    if rows < 0.995 or close < 0.99 or agree < 0.995:
        fail(f"{label}: the kernel disagrees with its plain version")
    del zp, trace
    ms = cuda_ms(lambda: scan._fwd_cuda(cur, *sc, False, False, False, md),
                 25)
    plain_ms = cuda_ms(lambda: scan._fwd_reference(cur, *sc, False, False,
                                                   False, md), 5, warmup=1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model_lib.forward_logits_pixels(
            cfg, params, x, enc, device="cuda"), 5)
    log(f"[{label}] per 4096-row batch: forward_logits_pixels {fwd_ms:.4f} "
        f"ms = {B / fwd_ms * 1e3:.1f} img/s, of it {fused.KERNEL_SCAN} "
        f"{ms:.4f} ms, the rest the input product and the readout's "
        f"per-step loop [{card_line()}]")
    if net == "ff-l":
        lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
        spikes = raster(lat, T, False, torch.float32).view(T, B, -1)
        spikes = spikes.transpose(0, 1)
        with torch.no_grad():
            fused.reset_launch_counts()
            r_logits = model_lib.forward_logits(cfg, params, spikes)
            torch.cuda.synchronize()
            got = launched(fused.launch_counts())
            if got != {fused.KERNEL_SCAN: 1}:
                fail(f"{label}: forward_logits on a raster launched {got}")
            if not bool(torch.isfinite(r_logits).all()):
                fail(f"{label}: non-finite logits on a raster")
            r_ms = cuda_ms(lambda: model_lib.forward_logits(cfg, params,
                                                            spikes), 5)
        log(f"[{label}] forward_logits on a TTFS raster {tuple(spikes.shape)}"
            f": {r_ms:.4f} ms = {B / r_ms * 1e3:.1f} img/s, one "
            f"{fused.KERNEL_SCAN} launch [{card_line()}]")
        del spikes
    nb, no = scan_work(T, B, H, md.itemsize, 0, False)
    row = kernel_row(label, f"{fused.KERNEL_SCAN}[{net}-{tag}]", SCAN_SITE,
                     launches[fused.KERNEL_SCAN], lerr, ms, plain_ms, nb, no,
                     md)
    del cur, z
    torch.cuda.empty_cache()
    return [row]


def expected_launches(paths, n):
    """{kernel: n} for every CUDA kernel that ``explain_dispatch``'s paths
    name (``cuda:fwd+bwd[mode]``)."""
    out = {}
    for p in paths:
        if p.startswith("cuda:"):
            for k in p[5:].split("[")[0].split("+"):
                out[k] = out.get(k, 0) + n
    return out


def phase_ff_train(net: str, matmul_dtype: str) -> list:
    """Phase 19: a feedforward net with constant-pixel input through
    ``Trainer`` at batch 8192, lr 1e-3: the first step's gradients against
    the per-step loop's (``use_kernels=False``; gated 1e-4 of max|g| in
    f32), 3 warm-up and FF_TIMED timed steps (finite falling loss, every
    trained leaf moves, one ``scan_fwd_train`` and one ``scan_bwd`` launch
    a step and no other kernel), three steps through the per-step loop
    (the parent commit's route) timed beside them; each kernel alone on
    batch 0 with the trained weights against its plain version (the
    backward on the forward kernel's residuals), timed; for 784-ALIF256-10
    also 5 steps with its own periodic encoding (the route
    ``explain_dispatch`` names, its launches and times)."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    label = f"ff-train {net} {tag}"
    md = getattr(torch, matmul_dtype)
    cfg = ff_cfg(net, matmul_dtype)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps, as_timeseries=False)
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, device="cuda", training=True)]
    if paths != [f"cuda:{fused.KERNEL_SCAN_TRAIN}+{fused.KERNEL_SCAN_BWD}",
                 "torch:loop"]:
        fail(f"{label}: dispatch is {paths}")
    batches = synthetic_task(4)
    x, y = batches[0]

    # The first step's gradients against the per-step loop's, same init.
    grads = {}
    for name, c in (("kernels", cfg), ("loop", ff_cfg(net, matmul_dtype,
                                                      False))):
        t = Trainer(c, seed=0, encode_config=enc, device="cuda")
        _, g = t.loss_and_grads(x, y)
        grads[name] = [g[n][k] for n in g for k in g[n]]
        del t, g
    loop_err = grad_error(grads["kernels"], grads["loop"])
    del grads
    torch.cuda.empty_cache()
    log(f"[{label}] first step's gradients vs the per-step loop: "
        f"{loop_err:.3g} of max|g|")
    if md == torch.float32 and loop_err > 1e-4:
        fail(f"{label}: the first step's gradients differ from the loop's")

    trainer = Trainer(cfg, seed=0, lr=1e-3, weight_decay=1e-5,
                      encode_config=enc, device="cuda")
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in trainer.params.items()}
    a_step = {fused.KERNEL_SCAN_TRAIN: 1, fused.KERNEL_SCAN_BWD: 1}
    warm, _ = timed_steps(trainer, batches, WARMUP)
    fused.reset_launch_counts()
    timed, seconds = timed_steps(trainer, batches, FF_TIMED, start=WARMUP)
    launches = fused.launch_counts()
    losses = [float(v) for v in warm + timed]
    log(f"[{label}] losses={[round(v, 3) for v in losses]}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        fail(f"{label}: loss did not fall ({first:.4f} -> {last:.4f})")
    if launched(launches) != {k: n * FF_TIMED for k, n in a_step.items()}:
        fail(f"{label}: launches {launches} in {FF_TIMED} steps")
    for n, g in trainer.params.items():
        for k, v in g.items():
            if torch.equal(v, before[n][k]):
                fail(f"{label}: {n}.{k} did not change")
    step_ms = seconds / FF_TIMED * 1e3
    loop = Trainer(ff_cfg(net, matmul_dtype, False), seed=0, lr=1e-3,
                   weight_decay=1e-5, encode_config=enc, device="cuda")
    timed_steps(loop, batches, 1)
    _, loop_s = timed_steps(loop, batches, 3, start=1)
    del loop
    log(f"[{label}] {FF_TIMED} steps of {TRAIN_B}: {step_ms:.3f} ms a step "
        f"= {TRAIN_B * FF_TIMED / seconds:.1f} img/s (the per-step loop: "
        f"{loop_s / 3 * 1e3:.3f} ms a step = {TRAIN_B * 3 / loop_s:.1f} "
        f"img/s); loss first5={first:.4f} last5={last:.4f}; launches="
        f"{json.dumps(launched(launches))} [{card_line()}]")

    # Each kernel alone on batch 0 with the trained weights.
    sc, c0 = ff_layer_args(cfg, trainer.params)
    alif = sc[1]
    store_a = fused._stores_a(alif, c0.spike_func)
    res_is_v = fused._residual_is_v(alif, c0.spike_func)
    cur = ff_currents(cfg, trainer.params, x)
    T, B, H = cur.shape
    z, res, a_tr = scan._fwd_cuda(cur, *sc, True, store_a, res_is_v, md)
    zp, resp, _ = scan._fwd_reference(cur, *sc, True, store_a, res_is_v, md)
    same = (z == zp).all(dim=2).all(dim=0)
    rows = float(same.float().mean())
    res_err = float((res[:, same].float() - resp[:, same].float())
                    .abs().max())
    rate = float(z.float().mean())
    del zp, resp
    if rows < 0.995:
        fail(f"{label}: spikes equal on {rows:.4f} of rows")
    g_z = cuda_randn((T, B, H), 19, std=1.0 / B, dtype=md)
    bw = (g_z, z, res, a_tr, res_is_v, sc[0], c0.alpha, c0.threshold,
          c0.gamma, c0.spike_func)
    g_err = check_grads(f"{label} scan backward",
                        lambda: (scan._bwd_cuda(*bw),),
                        lambda: (scan._bwd_reference(*bw),),
                        scan_bar(c0.spike_func))
    log(f"[{label}] kernels alone on batch 0: spikes equal on {rows:.4f} of "
        f"rows, residual err {res_err:.3g}, scan_bwd {g_err:.3g} of max|g| "
        f"({rate:.4f} of unit-steps fire)")
    t_f = cuda_ms(lambda: scan._fwd_cuda(cur, *sc, True, store_a, res_is_v,
                                         md), 10)
    t_f_p = cuda_ms(lambda: scan._fwd_reference(cur, *sc, True, store_a,
                                                res_is_v, md), 3, 1)
    t_b = cuda_ms(lambda: scan._bwd_cuda(*bw), 10)
    t_b_p = cuda_ms(lambda: scan._bwd_reference(*bw), 3, 1)
    n_res = 1 + int(a_tr is not None)
    fb, fo = scan_work(T, B, H, md.itemsize, n_res, False)
    bb, bo = scan_work(T, B, H, md.itemsize, n_res, True)
    out = [
        kernel_row(label, f"{fused.KERNEL_SCAN_TRAIN}[{net}-{tag}]",
                   SCAN_SITE, launches[fused.KERNEL_SCAN_TRAIN], res_err,
                   t_f, t_f_p, fb, fo, md),
        kernel_row(label, f"{fused.KERNEL_SCAN_BWD}[{net}-{tag}]",
                   SCAN_BWD_SITE, launches[fused.KERNEL_SCAN_BWD], g_err,
                   t_b, t_b_p, bb, bo, md)]
    del cur, z, res, a_tr, g_z, bw, trainer
    torch.cuda.empty_cache()

    if net == "ff-a":
        # Its own periodic encoding: the route the dispatch names.
        enc_p = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=True)
        rows_p = model_lib.explain_dispatch(cfg, enc_p, device="cuda",
                                            training=True)
        log(f"[{label}] periodic encoding, explain_dispatch(training=True): "
            f"{json.dumps(rows_p)}")
        periodic = Trainer(cfg, seed=0, encode_config=enc_p, device="cuda")
        timed_steps(periodic, batches, 1)
        fused.reset_launch_counts()
        plosses, pseconds = timed_steps(periodic, batches, 5)
        got = launched(fused.launch_counts())
        want = expected_launches([r["path"] for r in rows_p], 5)
        if got != want:
            fail(f"{label}: periodic launches {got}, expected {want}")
        if not all(np.isfinite([float(v) for v in plosses])):
            fail(f"{label}: non-finite loss with periodic encoding")
        log(f"[{label}] periodic 5 steps of {TRAIN_B}: "
            f"{pseconds / 5 * 1e3:.3f} ms a step = "
            f"{TRAIN_B * 5 / pseconds:.1f} img/s; launches={json.dumps(got)}"
            f" [{card_line()}]")
        del periodic
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 20-23: multi-seed ensembles (the stacked replica mode)
# ---------------------------------------------------------------------------
ENS_S = 6  # the seeds of scripts/ensemble_serve_bench.py, ensemble_throughput.py
ENS_TIMED = 10
# The flagship's random inits start far from chance (per-seed losses 10-130
# on the prototype task).  Under TTFS two of the six seeds' losses climb
# for tens of steps at phase 5's lr 1e-3 (seed 3: 10.5 -> 36 in 3 steps),
# at 1e-4 too, and the JAX trainer started from the same params climbs
# alike, step for step: the surrogate gradient's, not the port's.  At 1e-2
# Adam's second moments overflow within an epoch and the hidden weights
# turn NaN.  Phase 22 therefore trains at 1e-3 on the periodic encoding
# (that of scripts/ensemble_serve_bench.py and bench.py's training leg),
# where every seed's loss falls, and the fit on TTFS at batch 32.
ENS_LR = 1e-3
ENS_FIT_B = 32  # 109 steps an epoch on the 3481 training rows
STACKED_SITES = {  # kernel -> (its source, the TPU kernel's pl.pallas_call site)
    fused.KERNEL_STACKED: ("fused_head.cu", "pallas_fused.py:703"),
    fused.KERNEL_TRAIN_STACKED: ("fused_head.cu", "pallas_fused.py:703"),
    fused.KERNEL_BWD_STACKED: ("fused_head_bwd.cu", "pallas_fused.py:1092"),
    fused.KERNEL_IZH_STACKED: ("fused_izh.cu", "pallas_fused_izh.py:464"),
    fused.KERNEL_IZH_TRAIN_STACKED: ("fused_izh.cu",
                                     "pallas_fused_izh.py:464"),
    fused.KERNEL_IZH_BWD_STACKED: ("fused_izh_bwd.cu",
                                   "pallas_fused_izh.py:631"),
}


class LifHead:
    """The LIF/ALIF head's kernels and plain versions on one dict of
    arguments (``head_args``' keys; stacked weights carry a leading S)."""

    @staticmethod
    def _in(a):
        return (a["latencies"], a["w_in"], a["w_rec"], a["beta"], a["w_out"],
                a["b_out"], a["n_steps"], a["use_periods"], a["alif"],
                a["alpha"], a["rho"], a["threshold"], a["kappa"])

    @staticmethod
    def fwd(a, plain=False):
        stacked = a["w_in"].dim() == 3
        fn = (fused._head_cuda if not plain
              else fused._head_stacked_reference if stacked
              else fused._head_reference)
        return fn(*LifHead._in(a))

    @staticmethod
    def train(a, plain=False):
        stacked = a["w_in"].dim() == 3
        fn = (fused._head_train_cuda if not plain
              else fused._head_train_stacked_reference if stacked
              else fused._head_train_reference)
        return fn(*LifHead._in(a), True,
                  a["alif"] and a["spike_func"] == PHI, False)

    @staticmethod
    def bwd(a, g_logits, res, plain=False):
        stacked = a["w_in"].dim() == 3
        fn = (fused._head_bwd_cuda if not plain
              else fused._head_bwd_stacked_reference if stacked
              else fused._head_bwd_reference)
        _, delta, a_tr, tstar, _ = res
        return fn(g_logits, None, tstar, delta, a_tr, a["latencies"],
                  a["w_in"], a["w_rec"], a["beta"], a["w_out"], a["n_steps"],
                  a["use_periods"], a["alpha"], a["threshold"], a["gamma"],
                  a["kappa"], a["spike_func"])

    @staticmethod
    def at(a, s):
        return dict(a, w_in=a["w_in"][s],
                    w_rec=None if a["w_rec"] is None else a["w_rec"][s],
                    beta=fused.replica_beta(a["beta"], s),
                    w_out=a["w_out"][s], b_out=a["b_out"][s])


class IzhHead:
    """The Izhikevich head's kernels and plain versions on one dict of
    arguments (``lat, w_in, w_rec, w_out, b_out, n_steps, use_periods, kp,
    kappa, gamma, spike_func``)."""

    @staticmethod
    def _in(a):
        return (a["lat"], a["w_in"], a["w_rec"], a["w_out"], a["b_out"],
                a["n_steps"], a["use_periods"], a["kp"], a["kappa"])

    @staticmethod
    def _pick(a, plain):
        if not plain:
            return fused_izh._head_cuda
        return (fused_izh._head_stacked_reference if a["w_in"].dim() == 3
                else fused_izh._head_reference)

    @staticmethod
    def fwd(a, plain=False):
        return IzhHead._pick(a, plain)(*IzhHead._in(a), False, False)[0]

    @staticmethod
    def train(a, plain=False):
        return IzhHead._pick(a, plain)(*IzhHead._in(a), True, False)

    @staticmethod
    def bwd(a, g_logits, res, plain=False):
        stacked = a["w_in"].dim() == 3
        fn = (fused_izh._bwd_cuda if not plain
              else fused_izh._bwd_stacked_reference if stacked
              else fused_izh._bwd_reference)
        _, v, tstar, _ = res
        return fn(g_logits, None, tstar, None, None, v, a["lat"], a["w_in"],
                  a["w_rec"], a["w_out"], a["n_steps"], a["use_periods"],
                  a["kp"], a["gamma"], a["kappa"], a["spike_func"])

    @staticmethod
    def at(a, s):
        return dict(a, w_in=a["w_in"][s],
                    w_rec=None if a["w_rec"] is None else a["w_rec"][s],
                    w_out=a["w_out"][s], b_out=a["b_out"][s])


def stacked_lif_args(rng, S, B, F, H, O, T, alif, rec, per, spike, wdtype,
                     flagship, beta_tensor):
    """``head_args``' latencies and constants with S replicas' weights (the
    flagship's init scale or the JAX tests'); beta a float or an (S,)
    device tensor."""
    a = head_args(rng, B, F, H, O, T, alif, rec, per, wdtype, flagship,
                  spike)
    s_in, s_rec = (a["threshold"], a["threshold"]) if flagship else (0.5, 0.3)
    eye = 1 - torch.eye(H, device="cuda")
    a.update(
        w_in=rand_w(rng, (S, F, H), s_in, wdtype),
        w_rec=(rand_w(rng, (S, H, H), s_rec) * eye).to(wdtype) if rec
        else None,
        w_out=rand_w(rng, (S, H, O), 1.0, wdtype),
        b_out=rand_w(rng, (S, O), 0.1))
    if alif and beta_tensor:
        a["beta"] = rand_w(rng, (S,), 0.3) + (0.0 if flagship else 1.6)
    return a


def stacked_izh_args(rng, S, B, F, H, O, T, rec, wdtype):
    """S Izhikevich replicas at dt = 30 with init-scale weights (N(0, 1),
    where units fire), TTFS at the production tau."""
    pixels = torch.from_numpy(rng.random((B, F), dtype=np.float32)).cuda()
    eye = 1 - torch.eye(H, device="cuda")
    return dict(
        lat=pixels_to_firing_periods(pixels, t_max=float(T)).contiguous(),
        w_in=rand_w(rng, (S, F, H), 1.0, wdtype),
        w_rec=(rand_w(rng, (S, H, H), 1.0) * eye).to(wdtype) if rec else None,
        w_out=rand_w(rng, (S, H, O), 1.0, wdtype),
        b_out=rand_w(rng, (S, O), 0.1), n_steps=T, use_periods=False,
        kp=IZH30_KP, kappa=ReadoutConfig(input_size=1, output_size=1).kappa,
        gamma=IZH30.gamma, spike_func=IZH30.spike_func)


def check_stacked(label, fam, a, g_logits, bar, plain_fwd):
    """A stacked kernel triple against S single launches and its plain
    version.  Bitwise equal to the single launches, replica by replica:
    the inference logits, the training forward's logits, ``tstar`` and
    residuals, the backward's gradients on those residuals; the training
    logits equal the inference logits.  ``plain_fwd(a, logits)`` holds the
    forward against a plain version; the backward is held against the
    stacked plain version on the kernel's own residuals within ``bar`` of
    max|g|.  Returns the gradient error."""
    S = a["w_in"].shape[0]
    out = fam.fwd(a)
    res = fam.train(a)
    grads = fam.bwd(a, g_logits, res)
    torch.cuda.synchronize()
    if not torch.equal(res[0], out):
        fail(f"{label}: training logits differ from the inference logits")
    for s in range(S):
        a_s = fam.at(a, s)
        one = fam.fwd(a_s)
        one_res = fam.train(a_s)
        one_g = fam.bwd(a_s, g_logits[s].contiguous(), one_res)
        pairs = ([("logits", one, out[s])]
                 + [(f"train[{k}]", x, y[s]) for k, (x, y)
                    in enumerate(zip(one_res, res)) if x is not None]
                 + [(f"grad[{k}]", x, y[s]) for k, (x, y)
                    in enumerate(zip(one_g, grads)) if x is not None])
        for what, x, y in pairs:
            if not torch.equal(x, y):
                fail(f"{label}: replica {s} {what} differs from a single "
                     f"launch by {float((x.float() - y.float()).abs().max())}")
    plain_fwd(a, out)
    want = fam.bwd(a, g_logits, res, plain=True)
    err = grad_error(grads, want)
    if err > bar:
        fail(f"{label}: gradients {err:.3g} of max|g| from the plain "
             f"version, bar {bar:.3g}")
    return err


def close_small(label):
    def check(a, out):
        ref = LifHead.fwd(a, plain=True)
        if not torch.allclose(out, ref, atol=1e-5, rtol=1e-5):
            fail(f"{label}: logits {float((out - ref).abs().max()):.3g} from "
                 "the plain version")
    return check


def close_flagship(label):
    def check(a, out):
        ref = LifHead.fwd(a, plain=True)
        for s in range(out.shape[0]):
            agree, close, _, _ = compare_flagship(out[s], ref[s])
            if agree < 0.995 or close < 0.99:
                fail(f"{label}: replica {s} argmax_agree={agree:.4f} "
                     f"rows_within_1e-4max={close:.4f} against the plain "
                     "version")
    return check


def izh_ordered(label, rows=None):
    """At dt = 30 the cell amplifies last bits, so each replica's logits
    are held bitwise against the plain cell that sums in the kernel's
    order (``ordered_izh_head``), on the first ``rows`` rows (all where
    None; TTFS)."""
    def check(a, out):
        n = out.shape[1] if rows is None else rows
        for s in range(out.shape[0]):
            b = IzhHead.at(a, s)
            wit = ordered_izh_head(b["lat"][:n], b["w_in"], b["w_rec"],
                                   b["w_out"], b["b_out"], b["n_steps"],
                                   b["kp"], b["kappa"])
            if not torch.equal(wit, out[s, :n]):
                fail(f"{label}: replica {s} differs from the plain cell "
                     f"summed in the kernel's order on "
                     f"{int((wit != out[s, :n]).any(1).sum())} of {n} rows")
    return check


def phase_stacked_kernels() -> None:
    """The stacked replica mode of both head kernel triples (phase 20).

    Small, S = 3, B = 37, F = 50: 16 LIF/ALIF cases covering recurrent /
    feedforward x TTFS / periodic x FastSigmoid / Phi, each at one of T =
    23, 24, 100, float32 or bfloat16, beta a float or an (S,) tensor, H =
    19 or 45; 4 Izhikevich cases (recurrent / feedforward x float32 /
    bfloat16) at dt = 30, T = 24, H = 45.  Then the flagship at S = 6, B =
    8192, T = 100 (784-ALIF128-10, recurrent, beta an (S,) tensor), f32 and
    bf16, TTFS and periodic.  Everything of ``check_stacked``: bitwise
    against single launches on every replica and row; the LIF/ALIF logits
    within 1e-5 of the plain version (small) or the flagship bars (full);
    Izhikevich logits bitwise the plain cell in the kernel's order;
    gradients on the kernel's residuals within 2e-6 of max|g| (5e-6 at T =
    100; 1e-4 full width and Izhikevich at dt = 30; 2**-7 bf16)."""
    rng = np.random.default_rng(20)
    i = 0
    for alif in (True, False):
        for rec in (True, False):
            for per in (False, True):
                for spike in (FS, PHI):
                    T = (23, 24, 100)[i % 3]
                    wd = (torch.float32, torch.bfloat16)[(i // 2) % 2]
                    beta_t = bool((i + i // 4) % 2)
                    H = (19, 45)[(i // 8) % 2]
                    i += 1
                    label = (f"stacked {'alif' if alif else 'lif'}-"
                             f"{'rec' if rec else 'ff'}-"
                             f"{'periodic' if per else 'ttfs'}-{spike.name} "
                             f"T={T} H={H} {str(wd)[6:]} beta="
                             f"{'tensor' if beta_t else 'float'}")
                    a = stacked_lif_args(rng, 3, 37, 50, H, 10, T, alif,
                                         rec, per, spike, wd, False, beta_t)
                    g = rand_w(rng, (3, 37, 10), 1.0)
                    bar = (2.0 ** -7 if wd == torch.bfloat16
                           else 5e-6 if T == 100 else 2e-6)
                    err = check_stacked(label, LifHead, a, g, bar,
                                        close_small(label))
                    log(f"[stacked] {label}: equal to 3 single launches "
                        f"bitwise; grad_err={err:.3g} of max|g| ok")
    for rec in (True, False):
        for wd in (torch.float32, torch.bfloat16):
            label = (f"stacked izh-{'rec' if rec else 'ff'} dt=30 T=24 "
                     f"{str(wd)[6:]}")
            a = stacked_izh_args(rng, 3, 37, 50, 45, 10, 24, rec, wd)
            fire = float(IzhHead.train(a)[1].ge(IZH30.v_peak).float().mean())
            if fire == 0:
                fail(f"{label}: no unit fires")
            g = rand_w(rng, (3, 37, 10), 1.0)
            bar = IZH30_BAR if wd == torch.float32 else 2.0 ** -7
            err = check_stacked(label, IzhHead, a, g, bar, izh_ordered(label))
            log(f"[stacked] {label}: firing {fire:.3f}; equal to 3 single "
                f"launches bitwise; the plain cell in the kernel's order "
                f"bitwise; grad_err={err:.3g} of max|g| ok")
    for wd in (torch.float32, torch.bfloat16):
        for per in (False, True):
            label = (f"stacked flagship S={ENS_S} B={TRAIN_B} "
                     f"{'periodic' if per else 'ttfs'} {str(wd)[6:]}")
            a = stacked_lif_args(rng, ENS_S, TRAIN_B, 784, 128, 10, 100,
                                 True, True, per, FS, wd, True, True)
            g = rand_w(rng, (ENS_S, TRAIN_B, 10), 1.0 / TRAIN_B)
            bar = 1e-4 if wd == torch.float32 else 2.0 ** -7
            err = check_stacked(label, LifHead, a, g, bar,
                                close_flagship(label))
            log(f"[stacked] {label}: every replica and row equal to "
                f"{ENS_S} single launches bitwise; plain bars held; "
                f"grad_err={err:.3g} of max|g|")
            del a, g
            torch.cuda.empty_cache()


def stacked_row(label, kernel, tag, launches, err, ms, plain_ms, nbytes, ops,
                md):
    return kernel_row(label, f"{kernel}[{tag}]", STACKED_SITES[kernel],
                      launches, err, ms, plain_ms, nbytes, ops, md)


def ensemble_cfg(matmul_dtype, is_izh=False):
    return izh_cfg(matmul_dtype) if is_izh else flagship_cfg(matmul_dtype)


def ensemble_head_args(cfg, params, lat, use_periods, is_izh):
    """(family, arguments) of the stacked head call as
    ``forward_logits_pixels_stacked`` builds them from the params."""
    md = getattr(torch, cfg.matmul_dtype_eff)
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, ro = params["input"], params["readout"]
    w_in = p0["w_in"].detach().to(md).contiguous()
    w_rec = masked_recurrent(lcfg, p0).detach().to(md).contiguous()
    w_out = ro["w_in"].detach().to(md).contiguous()
    b_out = ro["b"].detach().contiguous()
    if is_izh:
        return IzhHead, dict(
            lat=lat, w_in=w_in, w_rec=w_rec, w_out=w_out, b_out=b_out,
            n_steps=cfg.int_time_steps, use_periods=use_periods,
            kp=izh.izh_kernel_params(lcfg), kappa=rcfg.kappa,
            gamma=lcfg.gamma, spike_func=lcfg.spike_func)
    return LifHead, dict(
        latencies=lat, w_in=w_in, w_rec=w_rec, beta=p0["beta"].detach(),
        w_out=w_out, b_out=b_out, n_steps=cfg.int_time_steps,
        use_periods=use_periods, alif=True, alpha=lcfg.alpha, rho=lcfg.rho,
        threshold=lcfg.threshold, gamma=lcfg.gamma, kappa=rcfg.kappa,
        spike_func=lcfg.spike_func)


def stacked_work(fam, a, is_izh, train):
    """(bytes, operations, hidden spikes) of a stacked forward on these
    inputs: S single calls' bytes less S - 1 reads of the shared latencies
    (each input read once, each output written once); the 0/1 products
    count this run's spikes."""
    lat = a["lat"] if is_izh else a["latencies"]
    S = a["w_in"].shape[0]
    B, F = lat.shape
    T, H, O = a["n_steps"], a["w_in"].shape[-1], a["w_out"].shape[-1]
    md = a["w_in"].dtype
    res = fam.train(a)
    hidden = int((res[1] >= IZH30.v_peak).sum()) if is_izh else int(
        (res[1] >= 0).sum())
    del res
    in_spikes = input_spike_count(lat, T, a["use_periods"])
    weights = (F * H + H * H + H * O) * md.itemsize
    trace = (4 if is_izh else md.itemsize) * T * B * H
    per = weights + O * 4 + 4 + B * O * 4 + (B * O * 4 + trace if train
                                             else 0)
    nbytes = B * F * 4 + S * per
    cell = IZH_CELL_OPS if is_izh else 10
    ops = (S * in_spikes * H + hidden * (H + O) + S * cell * B * T * H
           + S * 3 * B * T * O)
    return nbytes, ops, hidden, in_spikes


def phase_ensemble_serve(matmul_dtype: str, is_izh: bool = False) -> dict:
    """Six seeds served through ``EnsembleTrainer.serve()`` at batch 4096,
    16 requests of 512 uint8 rows (phase 21; with ``is_izh`` 784-Izh128-10
    at dt = 30, phase 23): every result within 1e-6 of ``predict_proba``
    (which takes the six unrolled single kernels), one stacked launch a
    batch and no other kernel; the stacked kernel on a served batch against
    its plain version (LIF/ALIF: the flagship bars on every replica;
    Izhikevich: every replica bitwise the plain cell summed in the kernel's
    order on WITNESS_ROWS rows), timed against six single launches and
    against its plain version."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    md = getattr(torch, matmul_dtype)
    label = f"ens-{'izh-' if is_izh else ''}serve {tag}"
    cfg = ensemble_cfg(matmul_dtype, is_izh)
    # scripts/ensemble_serve_bench.py's encoding: periodic (the Izhikevich
    # net TTFS, as phase 9 serves it).
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=not is_izh)
    ens = EnsembleTrainer(cfg, seeds=range(ENS_S), device="cuda")
    kernel = fused.KERNEL_IZH_STACKED if is_izh else fused.KERNEL_STACKED
    paths = [r["path"] for r in model_lib.explain_dispatch(
        cfg, enc, device="cuda", stacked=True)]
    if paths != [f"cuda:{kernel}"]:
        fail(f"{label}: stacked dispatch is {paths}")
    reqs, launches = serve_requests(
        label, cfg, ens.params, enc, {kernel: 1},
        server=lambda **kw: ens.serve(**kw),
        direct=lambda x: ens.predict_proba(x, enc), atol=1e-6)
    # The kernel alone on a served 4096-row batch.
    batch = np.concatenate(reqs[:4096 // ROWS])
    x = torch.from_numpy(batch).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    fam, a = ensemble_head_args(cfg, ens.params, lat, enc.use_periods,
                                is_izh)
    got, ref = fam.fwd(a), fam.fwd(a, plain=True)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    agree, close = (min(v) for v in zip(*(compare_flagship(got[s], ref[s])[:2]
                                          for s in range(ENS_S))))
    log(f"[{label}] stacked kernel vs plain on the served batch: lowest "
        f"replica argmax_agree={agree:.4f} rows_within_1e-4max={close:.4f} "
        f"max_abs_err={err:.3g}"
        + (" (dt=30: not gated, the cell amplifies last bits)" if is_izh
           else ""))
    if is_izh:
        izh_ordered(label, WITNESS_ROWS)(a, got)
        log(f"[{label}] every replica == the plain cell with the kernel's "
            f"summation order, bitwise, on {WITNESS_ROWS} rows")
    elif agree < 0.995 or close < 0.99:
        fail(f"{label}: the stacked kernel disagrees with its plain version")
    parts = [fam.at(a, s) for s in range(ENS_S)]
    ms = cuda_ms(lambda: fam.fwd(a), 25)
    unrolled = cuda_ms(lambda: [fam.fwd(p) for p in parts], 25)
    ms2 = cuda_ms(lambda: fam.fwd(a), 25)
    plain_ms = cuda_ms(lambda: fam.fwd(a, plain=True), 3, warmup=1)
    nbytes, ops, hidden, in_spikes = stacked_work(fam, a, is_izh, False)
    log(f"[{label}] per 4096-row batch of {ENS_S} seeds: stacked {ms:.4f} / "
        f"{ms2:.4f} ms, {ENS_S} single launches {unrolled:.4f} ms; the "
        f"kernel serves {4096 / ms * 1e3:.1f} img/s "
        f"({4096 * ENS_S / ms * 1e3:.1f} seed-img/s); input spikes "
        f"{in_spikes}, hidden spikes {hidden} "
        f"({hidden / (ENS_S * 4096 * 100 * 128):.4f}) [{card_line()}]")
    return stacked_row(label, kernel, tag, launches[kernel], err, ms,
                       plain_ms, nbytes, ops, md)


def phase_ensemble_train(matmul_dtype: str, is_izh: bool = False) -> list:
    """Six seeds trained by ``EnsembleTrainer`` at batch 8192 on phase 5's
    prototype task, ``fused_replicas="stacked"`` against the default
    (unrolled), periodic encoding (phase 22; with ``is_izh`` 784-Izh128-10
    at dt = 30 on TTFS, phase 23).  The first 3 steps: per-seed losses and
    every param bitwise equal between the two trainers, one stacked
    forward and one stacked backward launch a step (S of each single
    kernel unrolled).  Then ENS_TIMED more timed steps of each (stacked
    twice, 23 steps in all); every seed's mean loss of the last five steps
    must lie below that of the first five (LIF/ALIF; at dt = 30 the hidden
    BPTT gradients overflow Adam, as in phase 10, so there the readout must
    move) and beta stay bitwise; seed 0's 23 losses must equal those of
    ``Trainer(seed=0)`` on the same batches bit for bit.  lr ENS_LR.  Each
    stacked kernel alone on batch 0 with the trained weights: the forward
    against its plain version (LIF/ALIF: the flagship bars on every
    replica; Izhikevich: every replica bitwise the plain cell summed in the
    kernel's order on WITNESS_ROWS rows), the backward on the forward's
    residuals within 1e-4 of max|g| of its plain version (bf16 2**-7); both
    timed against S single launches and their plain versions."""
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    md = getattr(torch, matmul_dtype)
    label = f"ens-{'izh-' if is_izh else ''}train {tag}"
    cfg = ensemble_cfg(matmul_dtype, is_izh)
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps, use_periods=not is_izh)
    k_fwd, k_bwd = ((fused.KERNEL_IZH_TRAIN_STACKED,
                     fused.KERNEL_IZH_BWD_STACKED) if is_izh
                    else (fused.KERNEL_TRAIN_STACKED,
                          fused.KERNEL_BWD_STACKED))
    s_fwd, s_bwd = ((fused.KERNEL_IZH_TRAIN, fused.KERNEL_IZH_BWD) if is_izh
                    else (fused.KERNEL_TRAIN, fused.KERNEL_BWD))
    path = model_lib.explain_dispatch(cfg, enc, device="cuda", training=True,
                                      stacked=True)[0]["path"]
    if path != f"cuda:{k_fwd}+{k_bwd}":
        fail(f"{label}: stacked dispatch is {path}")
    stacked = EnsembleTrainer(cfg, seeds=range(ENS_S), lr=ENS_LR,
                              fused_replicas="stacked", device="cuda")
    unrolled = EnsembleTrainer(cfg, seeds=range(ENS_S), lr=ENS_LR,
                               device="cuda")
    start = {n: {k: v.detach().clone() for k, v in g.items()}
             for n, g in stacked.params.items()}
    batches = synthetic_task(4)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, tr, want in (("stacked", stacked, {k_fwd: 3, k_bwd: 3}),
                           ("unrolled", unrolled, {s_fwd: 3 * ENS_S,
                                                   s_bwd: 3 * ENS_S})):
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [tr.train_step(*batches[i], encode_config=enc)
                  for i in range(3)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = fused.launch_counts()
        if launched(got) != want:
            fail(f"{label}: {name} launches {launched(got)} in 3 steps, "
                 f"expected {want}")
        runs[name] = (torch.stack(losses), got)
        log(f"[{label}] {name} 3 steps: launches={json.dumps(launched(got))} "
            f"{seconds / 3 * 1e3:.3f} ms a step (first steps)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.equal(runs["stacked"][0], runs["unrolled"][0]):
        fail(f"{label}: stacked and unrolled per-seed losses differ: "
             f"{runs['stacked'][0].tolist()} vs "
             f"{runs['unrolled'][0].tolist()}")
    for n, g in stacked.params.items():
        for k, v in g.items():
            if not torch.equal(v, unrolled.params[n][k]):
                fail(f"{label}: {n}.{k} differs between the trainers")
    times = {"stacked": [], "unrolled": []}
    tails, order = [], [0, 1, 2]
    for name, tr in (("stacked", stacked), ("unrolled", unrolled),
                     ("stacked", stacked)):
        start_i = 3 + ENS_TIMED * (len(tails) if name == "stacked" else 0)
        picks = [(start_i + i) % 4 for i in range(ENS_TIMED)]
        if name == "stacked":
            order += picks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = [tr.train_step(*batches[i], encode_config=enc)
                for i in picks]
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / ENS_TIMED)
        if name == "stacked":
            tails.append(torch.stack(more))
    losses = torch.cat([runs["stacked"][0], *tails]).cpu().numpy()
    if not np.isfinite(losses).all():
        fail(f"{label}: non-finite losses {losses.tolist()}")
    if not is_izh:  # phase 5's gate: the mean of the first and last five
        fell = losses[-5:].mean(0) < losses[:5].mean(0)
        if not fell.all():
            fail(f"{label}: the loss did not fall for seeds "
                 f"{np.nonzero(~fell)[0].tolist()}: {losses.tolist()}")
    for n, g in stacked.params.items():
        for k, v in g.items():
            same = torch.equal(v, start[n][k])
            if k == "beta" and not same:
                fail(f"{label}: beta moved")
            if n == "readout" and same:
                fail(f"{label}: readout.{k} did not move")
    # Replica 0 is a single model trained alone: Trainer at seed 0 on the
    # same batches gives its losses bit for bit.
    single = Trainer(cfg, seed=0, lr=ENS_LR, encode_config=enc,
                     device="cuda")
    alone = torch.stack([single.train_step(*batches[i])
                         for i in order]).cpu().numpy()
    if not np.array_equal(alone, losses[:, 0]):
        fail(f"{label}: seed 0 of the ensemble differs from Trainer(seed=0): "
             f"{losses[:, 0].tolist()} vs {alone.tolist()}")
    st_ms = min(times["stacked"]) * 1e3
    un_ms = times["unrolled"][0] * 1e3
    log(f"[{label}] {ENS_S} seeds at B={TRAIN_B}: stacked {st_ms:.3f} ms a "
        f"step ({[round(t * 1e3, 3) for t in times['stacked']]}) = "
        f"{TRAIN_B * ENS_S / st_ms * 1e3:.1f} seed-img/s; unrolled "
        f"{un_ms:.3f} ms = {TRAIN_B * ENS_S / un_ms * 1e3:.1f} seed-img/s; "
        f"per-seed losses first={losses[0].round(3).tolist()} last="
        f"{losses[-1].round(3).tolist()}; peak allocated {peak:.2f} GiB "
        f"[{card_line()}]")
    # Each stacked kernel alone on batch 0 with the trained weights.
    x, _ = batches[0]
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    fam, a = ensemble_head_args(cfg, stacked.params, lat, enc.use_periods,
                                is_izh)
    res = fam.train(a)
    g = torch.full((ENS_S, TRAIN_B, 10), 1.0 / TRAIN_B, device="cuda")
    ref = fam.fwd(a, plain=True)
    err_f = float((res[0] - ref).abs().max())
    if is_izh:
        izh_ordered(label, WITNESS_ROWS)(a, res[0])
    else:
        for s in range(ENS_S):
            agree, close, _, _ = compare_flagship(res[0][s], ref[s])
            if agree < 0.995 or close < 0.99:
                fail(f"{label}: {k_fwd} replica {s} argmax_agree="
                     f"{agree:.4f} rows_within_1e-4max={close:.4f} against "
                     "the plain version")
    del ref
    err_b = grad_error(fam.bwd(a, g, res), fam.bwd(a, g, res, plain=True))
    bar = 1e-4 if md == torch.float32 else 2.0 ** -7
    if err_b > bar:
        fail(f"{label}: {k_bwd} {err_b:.3g} of max|g| from the plain "
             f"version on the forward's residuals, bar {bar:.3g}")
    torch.cuda.synchronize()
    log(f"[{label}] {k_fwd} on the trained weights: "
        + (f"every replica bitwise the plain cell in the kernel's order on "
           f"{WITNESS_ROWS} rows" if is_izh else "flagship bars held on "
           "every replica")
        + f" (max_abs_err {err_f:.3g}); {k_bwd}: {err_b:.3g} of max|g| "
        f"(bar {bar:.3g}) ok")
    f_ms = cuda_ms(lambda: fam.train(a), 10)
    b_ms = cuda_ms(lambda: fam.bwd(a, g, res), 10)
    f_plain = cuda_ms(lambda: fam.train(a, plain=True), 2, warmup=1)
    b_plain = cuda_ms(lambda: fam.bwd(a, g, res, plain=True), 2, warmup=1)
    parts = [fam.at(a, s) for s in range(ENS_S)]
    part_res = [fam.train(p) for p in parts]
    fu_ms = cuda_ms(lambda: [fam.train(p) for p in parts], 10)
    bu_ms = cuda_ms(lambda: [fam.bwd(p, g[s], part_res[s])
                             for s, p in enumerate(parts)], 10)
    del part_res, parts
    nbytes, ops, hidden, in_spikes = stacked_work(fam, a, is_izh, True)
    B, F, T, H, O = TRAIN_B, 784, 100, 128, 10
    weights = (F * H + H * H + H * O) * md.itemsize
    trace = (4 if is_izh else md.itemsize) * T * B * H
    b_bytes = B * F * 4 + ENS_S * (trace + 2 * B * O * 4 + 2 * weights
                                   + O * 4)
    chain = IZH_CHAIN_OPS if is_izh else 12
    b_ops = (ENS_S * (2 * B * T * H * (H + O) + in_spikes * H
                      + chain * B * T * H) + hidden * (H + O))
    log(f"[{label}] {k_fwd}: {f_ms:.4f} ms, {ENS_S} single launches "
        f"{fu_ms:.4f} ms; {k_bwd}: {b_ms:.4f} ms, {ENS_S} single launches "
        f"{bu_ms:.4f} ms; hidden spikes {hidden} "
        f"({hidden / (ENS_S * B * T * H):.4f}) [{card_line()}]")
    launches = runs["stacked"][1]
    return [
        stacked_row(label, k_fwd, tag, launches[k_fwd], err_f, f_ms, f_plain,
                    nbytes, ops, md),
        stacked_row(label, k_bwd, tag, launches[k_bwd], err_b, b_ms, b_plain,
                    b_bytes, b_ops, md),
    ]


def phase_ensemble_fit() -> None:
    """``EnsembleTrainer.fit`` on ``get_dataloaders(DatasetId.MNIST)`` (the
    synthetic set where no MNIST files exist; the source is printed), six
    seeds of the flagship, stacked, TTFS, batch ENS_FIT_B, with a checkpoint
    folder and ``checkpoint_every=1``: a fit of 2 epochs resumed from LAST_EPOCH
    for a third (on the same loaders, whose shuffles have advanced) must
    equal a continuous 3-epoch fit bitwise (histories and params);
    ``load_best()`` must install each seed's best epoch (its checkpoint
    file's slice); every seed's training and validation losses must be
    finite and lower after the third epoch than after the first; the
    ensemble must beat chance by three binomial standard errors on the
    test set.  lr ENS_LR."""
    cfg = flagship_cfg("float32")

    def loaders():
        return get_dataloaders(DatasetId.MNIST, batch_size=ENS_FIT_B, seed=0)

    def trainer(folder):
        return EnsembleTrainer(cfg, seeds=range(ENS_S), lr=ENS_LR,
                               fused_replicas="stacked",
                               checkpoint_folder=folder, device="cuda")

    with tempfile.TemporaryDirectory() as tmp:
        dl = loaders()
        log(f"[ens-fit] data source={dl['train'].source} train="
            f"{dl['train'].n_samples} val={dl['val'].n_samples} test="
            f"{dl['test'].n_samples}")
        t0 = time.perf_counter()
        trainer(f"{tmp}/resumed").fit(dl["train"], dl["val"], 2,
                                      verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        resumed = trainer(f"{tmp}/resumed")
        hist_r = resumed.fit(dl["train"], dl["val"], 3, verbose=False,
                             load_checkpoint_mode=LoadCheckpointMode.LAST_EPOCH)
        dc = loaders()
        whole = trainer(f"{tmp}/whole")
        hist_w = whole.fit(dc["train"], dc["val"], 3, verbose=False)
        if [h.to_dict() for h in hist_r] != [h.to_dict() for h in hist_w]:
            fail(f"ens-fit: resumed histories differ from the continuous "
                 f"fit: {[h.to_dict() for h in hist_r]} vs "
                 f"{[h.to_dict() for h in hist_w]}")
        for n, g in whole.params.items():
            for k, v in g.items():
                if not torch.equal(v, resumed.params[n][k]):
                    fail(f"ens-fit: resumed {n}.{k} differs from the "
                         "continuous fit")
        whole.load_best()
        for s, e in enumerate(whole.best_epoch):
            saved = whole.ckpt.load_checkpoint_at(int(e))[
                whole.ckpt.CHECKPOINT_STATE_DICT_KEY]
            for n, g in whole.params.items():
                for k, v in g.items():
                    if not torch.equal(v[s].cpu(), saved[n][k][s]):
                        fail(f"ens-fit: load_best seed {s} {n}.{k} is not "
                             f"epoch {e}'s")
        for s, h in enumerate(hist_w):
            tr, va = np.asarray(h["train"]), np.asarray(h["val"])
            if not (np.isfinite(tr).all() and np.isfinite(va).all()
                    and tr[-1] < tr[0] and va[-1] < va[0]):
                fail(f"ens-fit: seed {s}'s losses did not fall over 3 "
                     f"epochs: {h.to_dict()}")
        acc = whole.ensemble_accuracy(dc["test"])
        per_seed = whole.accuracies(dc["test"])
        # Chance plus three binomial standard errors of the test set's size.
        n_test = dc["test"].n_samples
        chance = 0.1 + 3.0 * (0.1 * 0.9 / n_test) ** 0.5
        if not acc > chance:
            fail(f"ens-fit: ensemble accuracy {acc} within chance ({chance:.4f});"
                 f" per seed "
                 f"{per_seed.tolist()}; histories "
                 f"{[h.to_dict() for h in hist_w]}")
        log(f"[ens-fit] 2 epochs {seconds:.2f} s; resume from LAST_EPOCH "
            f"for a third equals the continuous 3-epoch fit bitwise "
            f"(histories and params); best epochs {whole.best_epoch.tolist()}"
            f" installed by load_best; test accuracy ensemble {acc:.4f}, "
            f"per seed {np.round(per_seed, 4).tolist()}; every seed's losses "
            f"fell; per-seed train losses by epoch "
            f"{[np.round(h['train'], 4).tolist() for h in hist_w]}, val "
            f"{[np.round(h['val'], 4).tolist() for h in hist_w]}")


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card_line()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    kernels = []

    def run(label, fn, *args):
        """One phase, its seconds logged; its rows join the kernels line."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {label}: {time.perf_counter() - t0:.1f} s")
        if isinstance(out, dict):
            kernels.append(out)
        elif out:
            kernels.extend(out)

    both = ("float32", "bfloat16")
    run("2 build", phase_build)
    run("3 head kernels", phase_kernels)
    run("3 training kernels", phase_train_kernels)
    run("3b deep kernels", phase_deep_kernels)
    for md in both:
        run(f"4 serve {md}", phase_serve, md)
    for md in both:
        run(f"5 train {md}", phase_train, md)
    for md in both:
        run(f"6 deep serve {md}", phase_deep_serve, md)
    for md in both:
        run(f"7 deep train {md}", phase_deep_train, md)
    run("8 Izhikevich kernels", phase_izh_kernels)
    for md in both:
        run(f"9 Izhikevich serve {md}", phase_izh_serve, md)
    for md in both:
        run(f"10 Izhikevich train {md}", phase_izh_train, md)
    run("11 two-layer kernels", phase_fused2_kernels)
    for md in both:
        run(f"12 two-layer serve {md}", phase_twolayer_serve, md)
    for md in both:
        run(f"13 two-layer train {md}", phase_twolayer_train, md)
    run("14 wide kernels", phase_wide_kernels)
    for md in both:
        run(f"15 wide serve {md}", phase_wide_serve, md)
    for md in both:
        run(f"16 wide train {md}", phase_wide_train, md)
    run("17 scan kernels", phase_scan_kernels)
    for net in FF_NETS:
        for md in both:
            run(f"18 ff serve {net} {md}", phase_ff_serve, net, md)
    for net in FF_NETS:
        for md in both:
            run(f"19 ff train {net} {md}", phase_ff_train, net, md)
    run("20 stacked kernels", phase_stacked_kernels)
    for md in both:
        run(f"21 ensemble serve {md}", phase_ensemble_serve, md)
    for md in both:
        run(f"22 ensemble train {md}", phase_ensemble_train, md)
    run("22 ensemble fit", phase_ensemble_fit)
    for md in both:
        run(f"23 Izhikevich ensemble serve {md}", phase_ensemble_serve, md,
            True)
        run(f"23 Izhikevich ensemble train {md}", phase_ensemble_train, md,
            True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
