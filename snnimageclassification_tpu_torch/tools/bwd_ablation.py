"""Where the backward kernel's time goes: time the four ``__global__``
functions of ``fused_head_bwd`` (``csrc/fused_head_bwd.cu`` over
``csrc/bwd_common.cuh``: the chain, ``bwd_gwin`` for ``g_W_in``,
``bwd_gbits`` for ``g_W_rec``, ``bwd_gout`` for ``g_W_out`` and ``g_b``;
at the flagship the chain takes its tensor-core kernel) apart, as built
and with one piece of work removed at a time; and, with ``--library``,
the one PyTorch call of each gradient function's product on materialised
operands, and each function's bound.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.bwd_ablation \
        [--matmul-dtype float32|bfloat16] [--periodic] [--library]

The inputs are one training batch of the flagship (784 -> ALIF-128
recurrent, learn_beta, T=100, batch 8192, init weights from seed 0, random
pixels; periodic latencies at the encoders' own tau) with the residuals
of ``fused_head_fwd_train``.  Each variant is the source, headers inlined,
with one statement replaced (removing work changes the gradients, so only the
times mean anything):

* ``bwd_gwin``: ``no_dcur_reads`` (every batch's TMA boxes from the
  first rows, L2-resident), ``no_period_table`` (each period's sum one
  term), ``no_gather`` (no table read a (row, feature));
* ``bwd_gout``: ``no_s_chains`` (no kappa recurrence), ``no_out_sums``
  (no z(t) s_r(t) adds past t = 0), and ``gout_mma``, which adds nothing
  but launches the tensor-core form (``csrc/gout_mma.cuh``) in its place;
* ``bwd_gbits``: ``no_rec_sums``, ``no_mask_reads``, ``no_gbits_dcur_reads``;
* the chain: ``no_chain_rec_product``, ``no_chain_out_product``.

Prints one JSON line per variant: device milliseconds per launch of each
function (median of 5 launches, ``torch.profiler``); with ``--library`` one
line of each function's library call (median of 10 by CUDA events: ``raster^T
@ dcur``, ``z_prev^T @ dcur``, ``z^T @ s_r`` and ``s.sum``) and bound
(bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the larger);
then the card's name and power limit.  Builds go to
``.torch_ext_build/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import LayerType, SNNConfig
from ..models import snn as model_lib
from ..ops import _build, fused
from ..ops.cells import masked_recurrent
from ..ops.encoding import pixels_to_firing_periods, spike_row

VARIANTS = {  # name -> (statement of the kernel's source, its replacement)
    "no_dcur_reads": ("i * q.TB - 1, row0 + r);", "i * q.TB - 1, r);"),
    "no_period_table": (
        "p == 0 ? to_f32(col[0]) : period_sum(col, 32, p, T);",
        "to_f32(col[0]);"),
    "no_gather": (
        "acc[c * 8 + j] += to_f32(tab[k * 32]);",
        "if (k == 0xffff) acc[c * 8 + j] += to_f32(tab[k * 32]);"),
    "no_s_chains": ("s = a.kappa * s + gl * (ts == t ? 1.f : 0.f);",
                    "s = gl;"),
    "no_out_sums": ("for (int t = 0; t < te; ++t) {",
                    "for (int t = 0; t < min(te, 1); ++t) {"),
    "gout_mma": ("return launch_gout<W>(a, p.go, S, s);",
                 "return launch_gout_mma<W>(a, p.go, S, s);"),
    "no_rec_sums": ("if ((m >> i) & 1u) acc[i] += d;",
                    "if (i == 0) acc[0] += d;"),
    "no_mask_reads": ("s_bm[i] = brow[i];",
                      "s_bm[i] = 0x55555555u << (i & 1);"),
    "no_gbits_dcur_reads": ("const uint4 v = q[i];",
                            "const uint4 v = make_uint4(i, i, i, i);"),
    "no_chain_rec_product": (
        "mma_split_a<P>(rec[n], da, s_wrec, kk * (HP / 8) + MMA_NT * wu + n,\n"
        "                         lane);",
        "rec[n][0] += 0.f;"),
    "no_chain_out_product": (
        "mma_split_a<P>(dz[n], sa, s_wout, MMA_NT * wu + n, lane);",
        "dz[n][0] += 0.f;"),
}
FUNCTIONS = ("bwd_chain", "bwd_gwin", "bwd_gbits", "bwd_gout")
BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12  # H100 SXM, 700 W


def _variant_so(name: str, source: str):
    """Builds a variant's library (one nvcc; kept where the same source
    was built before) and returns its path."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"bwd_{name}.cu", out_dir / f"libbwd_{name}.so"
    if so.exists() and cu.exists() and cu.read_text() == source:
        return so
    cu.write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return so


def _function_ms(fn, n: int = 5) -> dict:
    """Median device ms of each bwd_* function over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    times: dict = {}
    for _ in range(n):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for part in FUNCTIONS:
                if part in ev.key:
                    times.setdefault(part, []).append(
                        ev.self_device_time_total / 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def _events_ms(fn, n: int = 10) -> float:
    """Median ms of ``fn`` over ``n`` runs by CUDA events, after a warm-up."""
    for _ in range(3):
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


def _library(lat, delta, tstar, g_logits, dcur, kappa, periodic, md):
    """Each gradient function's one PyTorch call on materialised operands
    (rows (b, t) of the batch) and its bound."""
    B, F = lat.shape
    T, _, H = delta.shape
    O = g_logits.shape[1]
    es = md.itemsize
    d = dcur.reshape(B * T, H)
    z = (delta >= 0).permute(1, 0, 2)  # (B, T, H): z(t)
    z_prev = torch.cat([torch.zeros_like(z[:, :1]), z[:, :-1]], 1)
    s = torch.zeros((B, O), device=lat.device)
    s_t = torch.empty((B, T, O), device=lat.device)
    for t in range(T - 1, -1, -1):
        s = kappa * s + g_logits * (tstar == t).float()
        s_t[:, t] = s
    s_r = s_t.to(md).reshape(B * T, O)
    s_flat = s_t.reshape(B * T, O)
    raster = torch.stack([spike_row(lat, t, T, periodic) for t in range(T)],
                         1).to(md).reshape(B * T, F)
    zf, zpf = z.reshape(B * T, H).to(md), z_prev.reshape(B * T, H).to(md)
    out = {
        "bwd_gwin": _events_ms(lambda: raster.T @ d),
        "bwd_gbits": _events_ms(lambda: zpf.T @ d),
        "bwd_gout": {"z^T @ s_r": _events_ms(lambda: zf.T @ s_r),
                     "s.sum": _events_ms(lambda: s_flat.sum(0))},
    }
    # Bounds: each input read once, each output written once; float32
    # adds of the selected rows (and the periodic table) at 67 TFLOP/s.
    key = fused.spike_keys(lat, T, periodic)
    if periodic:
        table = 0
        for b in range(0, B, 1024):
            used = torch.zeros((min(1024, B - b), T + 1), dtype=torch.bool,
                               device=lat.device)
            used.scatter_(1, key[b:b + 1024].long() + 1, True)
            p = torch.arange(T + 1, device=lat.device) - 1
            steps = torch.where(p > 0, (T - 1) // p.clamp(min=1), 0)
            table += int((used.long() * steps).sum())
        gwin_ops = B * F * H + table * H
    else:
        gwin_ops = int((key >= 0).sum()) * H
    hidden = int(z.sum())
    bounds = {
        "bwd_gwin": (B * T * H * es + B * F * 4 + F * H * 4, gwin_ops),
        "bwd_gbits": (B * T * H * es + B * (T + 1) * ((H + 31) // 32) * 4
                      + H * H * 4, int(z_prev.sum()) * H),
        "bwd_gout": (B * (T + 1) * ((H + 31) // 32) * 4 + 2 * B * O * 4
                     + (H * O + O) * 4, hidden * O + B * T * O),
    }
    bound = {}
    for k, (nbytes, ops) in bounds.items():
        tb, to = nbytes / BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        bound[k] = {"bytes": nbytes, "ops": ops, "bound_ms": max(tb, to),
                    "bound_by": "bytes" if tb >= to else "operations"}
    return out, bound


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--library", action="store_true")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablation needs a CUDA card")
    md = getattr(torch, ns.matmul_dtype)
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=100, matmul_dtype=ns.matmul_dtype)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    B = 8192
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, 784), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, ro = params["input"], params["readout"]
    w_in = p0["w_in"].to(md).contiguous()
    w_rec = masked_recurrent(lcfg, p0).to(md).contiguous()
    w_out = ro["w_in"].to(md).contiguous()
    _, delta, _, tstar, _ = fused._head_train_cuda(
        lat, w_in, w_rec, p0["beta"], w_out, ro["b"].contiguous(), 100,
        ns.periodic, True, lcfg.alpha, lcfg.rho, lcfg.threshold, rcfg.kappa,
        True, False, False)
    g_logits = torch.full((B, 10), 1.0 / B, device="cuda")
    keep: dict = {}

    def run():
        fused._head_bwd_cuda(g_logits, None, tstar, delta, None, lat, w_in,
                             w_rec, p0["beta"], w_out, 100, ns.periodic,
                             lcfg.alpha, lcfg.threshold, lcfg.gamma,
                             rcfg.kappa, lcfg.spike_func, keep=keep)

    source = _build.inlined_source("fused_head_bwd")
    variants = {}
    for name, (old, new) in VARIANTS.items():
        if source.count(old) != 1:
            raise SystemExit(f"{name}: statement not found once in the "
                             "source")
        variants[name] = source.replace(old, new)
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant
        paths = dict(zip(variants, pool.map(_variant_so, variants,
                                            variants.values())))
    libs = {"kernel": _build.load("fused_head_bwd")}
    libs.update({n: ctypes.CDLL(str(p)) for n, p in paths.items()})
    tag = {"matmul_dtype": ns.matmul_dtype,
           "encoding": "periodic" if ns.periodic else "ttfs"}
    try:
        for name, lib in libs.items():
            _build._libs["fused_head_bwd"] = lib  # what fused._lib() loads
            print(json.dumps({"variant": name, **tag,
                              "ms": _function_ms(run)}), flush=True)
    finally:
        _build._libs["fused_head_bwd"] = libs["kernel"]
    if ns.library:
        run()
        print(json.dumps({"whole_call_ms": _events_ms(run), **tag}),
              flush=True)
        lib_ms, bound = _library(lat, delta, tstar, g_logits, keep["dcur"],
                                 rcfg.kappa, ns.periodic, md)
        print(json.dumps({"library_ms": lib_ms, "bound": bound, **tag}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
