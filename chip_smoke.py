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
   for the launches.

Then one JSON line describing every kernel (launches from its phase's
main run, times and bound on that run's inputs), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import snnimageclassification_tpu_torch as pt
from snnimageclassification_tpu_torch.models import snn as model_lib
from snnimageclassification_tpu_torch.ops import _build, fused
from snnimageclassification_tpu_torch.ops.cells import (
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
    masked_recurrent,
)
from snnimageclassification_tpu_torch.ops.encoding import (
    pixels_to_firing_periods,
    spike_row,
)
from snnimageclassification_tpu_torch.ops.surrogate import SpikeFuncType
from snnimageclassification_tpu_torch.train import (
    L2SpikesPerNeuron,
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
SOURCES = ("fused_head", "fused_head_bwd")


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


def phase_serve(matmul_dtype: str) -> dict:
    tag = "f32" if matmul_dtype == "float32" else "bf16"
    cfg = flagship_cfg(matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    enc = pt.EncodeConfig(n_steps=cfg.int_time_steps)
    path = model_lib.explain_dispatch(cfg, enc, device="cuda")[0]["path"]
    if path != f"cuda:{fused.KERNEL}":
        fail(f"serve {tag}: dispatch is {path}, not the head kernel")
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, 256, size=(ROWS, 784), dtype=np.uint8)
            for _ in range(N_THREADS * PER_THREAD)]
    results = [None] * len(reqs)
    with pt.InferenceServer(cfg, params, batch_size=4096, max_delay_s=0.05,
                            input_dtype=np.uint8, device="cuda") as srv:
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
        launches = fused.launch_counts()[fused.KERNEL]
        if any(t.is_alive() for t in threads):
            fail(f"serve {tag}: requests did not finish")
        snap = srv.stats.snapshot()
    batches = snap["batches"] - warm_batches
    log(f"[serve] {tag} stats={json.dumps(snap)}")
    log(f"[serve] {tag} served {len(reqs) * ROWS} rows in {wall:.4f} s = "
        f"{len(reqs) * ROWS / wall:.1f} img/s over {batches} batches; "
        f"{fused.KERNEL} launches={launches} [{card_line()}]")
    if launches < 1:
        fail(f"serve {tag}: the head kernel was never launched")
    if launches != batches:
        fail(f"serve {tag}: {launches} launches for {batches} batches")

    # Every result against a direct forward on the card: same kernel, same
    # per-row arithmetic, so bitwise.
    for req, got in zip(reqs, results):
        x = torch.from_numpy(req).cuda().to(torch.float32) / 255.0
        want = model_lib.forward_logits_pixels(cfg, params, x, enc,
                                               device="cuda")
        want = want.cpu().numpy()
        if got.shape != (ROWS, 10) or not np.isfinite(got).all():
            fail(f"serve {tag}: bad result {got.shape}")
        if not np.array_equal(got, want):
            fail(f"serve {tag}: result differs from the direct forward by "
                 f"{np.abs(got - want).max():.3g}")
    log(f"[serve] {tag}: {len(reqs)} results equal the direct forward "
        "bitwise")

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
    if launches != {fused.KERNEL: 0, fused.KERNEL_TRAIN: TIMED,
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
        f"{json.dumps(launches)} [{card_line()}]")
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
    if got != {fused.KERNEL: 0, fused.KERNEL_TRAIN: 3, fused.KERNEL_BWD: 3}:
        fail(f"train {tag}: count-regularized launches {got}")
    if not all(np.isfinite([float(v) for v in rlosses])):
        fail(f"train {tag}: non-finite count-regularized loss")
    log(f"[train] {tag} L2SpikesPerNeuron 3 steps: launches="
        f"{json.dumps(got)} losses={[round(float(v), 4) for v in rlosses]}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card_line()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_build()
    phase_kernels()
    phase_train_kernels()
    kernels = [phase_serve("float32"), phase_serve("bfloat16")]
    kernels += phase_train("float32") + phase_train("bfloat16")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
