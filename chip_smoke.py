"""Drive the PyTorch port on one CUDA card and check its kernels.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. device  -- require CUDA; print the card's name and power limit;
2. build   -- compile every kernel of the port from ``csrc/`` (nvcc,
   sm_90a, one process per source) and print the build seconds;
3. kernels -- each kernel's wrapper against its plain PyTorch version on
   the card: four head variants x {float32, bfloat16} weights at a small
   shape (logits to atol=rtol=1e-5) and at the flagship shape (B=4096,
   784-128-10, T=100: argmax equal on >= 99.5 % of rows, logits within
   1e-4 * max|logit| on >= 99 % of rows);
4. serve   -- the flagship (784 -> ALIF-128 recurrent, learn_beta, T=100)
   served by ``InferenceServer`` at batch 4096 with uint8 wire input, for
   float32 and for bfloat16 matmul weights: 4 threads submit 32 requests
   of 512 rows; every result must equal a direct ``forward_logits_pixels``
   on the card bitwise, and the head kernel's launch count for that run
   must be non-zero.  Prints the server stats, served images/s and the
   kernel's time per 4096-row batch (CUDA events, median of 25).

Then one JSON line describing every kernel (launches from phase 4, times
and bound on phase 4's inputs), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.
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
    ALIFState,
    LIFConfig,
    ReadoutConfig,
    alif_step,
    masked_recurrent,
)
from snnimageclassification_tpu_torch.ops.encoding import (
    pixels_to_firing_periods,
    spike_row,
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
SOURCES = ("fused_head",)


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


def head_args(rng, B, F, H, O, T, alif, rec, use_periods, wdtype, flagship):
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
                threshold=cfg.threshold, kappa=kappa)


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


# ---------------------------------------------------------------------------
# Phase 4: the main path through InferenceServer
# ---------------------------------------------------------------------------
N_THREADS, PER_THREAD, ROWS = 4, 8, 512


def flagship_cfg(matmul_dtype):
    return pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=128,
        hidden_layer_type=pt.LayerType.ALIF, use_recurrent_connection=True,
        learn_beta=True, int_time_steps=100, matmul_dtype=matmul_dtype,
    )


def head_work(lat, T, H, O, recurrent, hidden_spikes, itemsize):
    """(bytes, operations) the head needs on these inputs: each input read
    once and the logits written once; one add per selected weight of the
    0/1 products (input spikes x H, hidden spikes x (H + O)) plus ~10
    float32 operations per (row, step, unit) of the dynamics and 3 per
    (row, step, output) of the readout."""
    B, F = lat.shape
    in_spikes = sum(int(spike_row(lat, t, T, False).sum()) for t in range(T))
    weights = (F * H + (H * H if recurrent else 0) + H * O) * itemsize
    nbytes = lat.numel() * 4 + weights + O * 4 + 4 + B * O * 4
    ops = (in_spikes * H + hidden_spikes * ((H if recurrent else 0) + O)
           + 10 * B * T * H + 3 * B * T * O)
    return nbytes, ops, in_spikes


def hidden_spike_count(params, cfg, lat):
    """Hidden spikes of the whole run, from the plain loop on the card."""
    (_, lcfg), _ = cfg.layer_configs
    p = params["input"]
    wd = getattr(torch, cfg.matmul_dtype_eff)
    w_in = p["w_in"].to(wd).float()
    w_rec = masked_recurrent(lcfg, p).to(wd).float()
    B, H = lat.shape[0], w_in.shape[1]
    z = torch.zeros((B, H), device=lat.device)
    state = ALIFState(z, z, z)
    total = 0
    for t in range(cfg.int_time_steps):
        cur = spike_row(lat, t, cfg.int_time_steps, False).float() @ w_in
        z, state = alif_step(lcfg, p, state, cur, w_rec_eff=w_rec,
                             precomputed_input_current=True)
        total += int(z.sum())
    return total


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
    p0, pr = params["input"], params["readout"]
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    args = dict(
        latencies=lat, w_in=p0["w_in"].to(md).contiguous(),
        w_rec=masked_recurrent(lcfg, p0).to(md).contiguous(),
        beta=p0["beta"], w_out=pr["w_in"].to(md).contiguous(),
        b_out=pr["b"].contiguous(), n_steps=100, use_periods=False,
        alif=True, alpha=lcfg.alpha, rho=lcfg.rho,
        threshold=lcfg.threshold, kappa=rcfg.kappa)
    got, ref = run_head(args, False), run_head(args, True)
    torch.cuda.synchronize()
    agree, close, err, scale = compare_flagship(got, ref)
    log(f"[serve] {tag} kernel vs plain on the served batch: argmax_agree="
        f"{agree:.4f} rows_within_1e-4max={close:.4f} max_abs_err={err:.3g}")
    if agree < 0.995 or close < 0.99:
        fail(f"serve {tag}: kernel disagrees with its plain version")
    ms = cuda_ms(lambda: run_head(args, False), 25)
    plain_ms = cuda_ms(lambda: run_head(args, True), 5, warmup=1)
    hidden = hidden_spike_count(params, cfg, lat)
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


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card_line()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_build()
    phase_kernels()
    kernels = [phase_serve("float32"), phase_serve("bfloat16")]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
