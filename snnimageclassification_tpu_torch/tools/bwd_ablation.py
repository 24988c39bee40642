"""Where the backward kernel's time goes: time the four ``__global__``
functions of ``fused_head_bwd`` (``csrc/fused_head_bwd.cu`` over
``csrc/bwd_common.cuh``: the chain, ``bwd_gwin`` for ``g_W_in``,
``gbits_mma`` (``csrc/gbits_mma.cuh``) for ``g_W_rec``, ``bwd_gout`` for
``g_W_out`` and ``g_b``; at the flagship the chain takes its tensor-core
kernel) apart, as built and with one piece of work removed at a time; and,
with ``--library``, the one PyTorch call of each gradient function's product
on materialised operands, and each function's bound.  ``--replicas S``
also times those calls as ``torch.bmm`` over S stacked copies (the
ensemble's stacked backward).  ``--wide`` times ``rec_scan_bwd``'s two
functions instead (784 -> ALIF-512 -> 10, B = 8192, T = 100: the chain and
``g_W_rec``) as built.  Where the chain runs its tensor-core cluster body
(bf16), also without its recurrent product (``no_chain_rec_product``),
without the exchange of the rounded dcur (``no_chain_exchange``: no copies
into the peers and no wait on them), without its element-wise loads
(``no_chain_loads``: constants), with two exchange buffers where the plan
takes one (``chain_two_buffers``: fewer rows a cluster), and on the
CUDA-core body (``cuda_core_chain``), then the plans and the whole call on
one cluster's rows alone (the step's latency); where it runs the CUDA-core
body (float32), also on the cluster body (``cluster_chain``).  With
``--library`` its ``z_prev^T @ round(g_i)``.
``--izh`` times ``fused_izh_bwd``'s four functions instead (784 ->
Izhikevich-128 recurrent -> 10 at dt = 30, B = 8192, T = 100, seed 0: the
chain on tensor cores, ``bwd_gwin``, ``gbits_mma``, ``bwd_gout``), as built,
with the chain's two products removed, and with its per-unit chain
(``izh_chain_kernel``, the chain before the tensor-core body).
``--mid`` times ``fused_mid_bwd``'s functions in both modes (the deep net
784 -> 128 -> 128 -> 96 -> 10, B = 8192, T = 100, init weights from seed 0,
random pixels: the z-emitting mode 128 -> 128 and the head mode 128 -> 96
-> 10 on the residuals of ``fused_mid_fwd``: ``pack_bits``, the chain,
``gzin_mma`` for ``g_z_in``, ``gbits_mma`` twice, ``bwd_gout``), and
``--twolayer`` ``fused2_bwd``'s (784-ALIF128-ALIF128-10: both chains,
``gzin_mma`` for ``dz0``, ``bwd_gwin``, ``gbits_mma`` three times,
``bwd_gout``), each as built, with the chains on the per-unit body
(``per_unit_chain``) and without the chains' recurrent product
(``no_chain_rec_product``); with
``--library`` ``dcur @ W_in^T`` as one ``torch.matmul`` on materialised
operands laid out ``(T, B, Hin)`` as the kernel writes it, ``gzin_mma``
alone (``fused_mid.gzin``) and its bound.
``--layer0`` times ``fused_layer0_bwd``'s functions (layer 0 of the deep
net 784 -> ALIF-128 recurrent -> 128 -> 96 -> 10 on the residuals of
``fused_layer0_fwd``: the chain, ``bwd_gwin``, ``gbits_mma``) and, with
``--izh``, ``fused_izh_layer0_bwd``'s (layer 0 of 784 -> Izhikevich-128
recurrent -> Izhikevich-128 -> 10 at dt = 30), each as built (the chain on
the tensor-core chain body), with the per-unit chain (``per_unit_chain``:
``bwd_chain_kernel``, ``izh_chain_kernel``) and without the chain's
recurrent product (``no_chain_rec_product``), and the chain's bound.

``--izh-scan`` times ``izh_scan_bwd``'s functions (``csrc/izh_scan.cu``:
the chain and ``gbits_mma`` for ``g_W_rec``) on the deep Izhikevich
network's second layer (784-Izh128-Izh128-10 at dt = 30, params seed 0,
B = 8192, T = 100: the residuals of ``izh_scan_fwd`` on its currents, as
``head_ablation.py --izh-scan`` makes them), as built (the chain on the
tensor-core chain body, ``gbits_mma`` reading the chain's float32 g_i),
with the per-unit chain (``per_unit_chain``: ``izh_chain_kernel``) and without the
chain's recurrent product (``no_chain_rec_product``), and the chain's
bound.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.bwd_ablation \
        [--matmul-dtype float32|bfloat16] [--periodic] [--library] \
        [--replicas 6] [--wide | --izh | --mid | --twolayer | --layer0
        [--izh] | --izh-scan]

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
* ``gbits_mma``: ``no_rec_sums`` (no tensor-core products; the A and B
  fragments still built), ``no_mask_reads`` (no A fragments built from
  the mask words: constant ones), ``no_gbits_dcur_reads`` (every slice's
  TMA box from the replica's first rows, L2-resident),
  ``no_gbits_compute`` (no slice computed: the stages, mask words, A
  fragments and barriers alone), ``no_gbits_stage_barrier`` (no block
  barrier a stage), and ``gbits_slices_unrolled``, which removes no work
  but unrolls the loop over a stage's four slices;
* the chain: ``no_chain_rec_product``, ``no_chain_out_product``.

Prints one JSON line per variant: device milliseconds per launch of each
``__global__`` function of the port's sources (median of 5 launches,
``torch.profiler``); with ``--library`` one line of each function's library
call (median of 10 by CUDA events: ``raster^T @ dcur``, ``z_prev^T @
dcur``, ``z^T @ s_r`` and ``s.sum``) and bound (bytes over 3.35 TB/s, or
operations: float32 adds at 67 TFLOP/s, ``gbits_mma``'s tensor-core work,
one product a bf16 piece, at 989 TFLOP/s; the larger); then the card's
name and power limit.  Builds go to ``.torch_ext_build/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import LayerType, SNNConfig
from ..models import snn as model_lib
from ..ops import _build, fused, fused_izh, izh, rec_scan
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
    "no_rec_sums": (
        "mma_exact<P>(acc[mt][2 * n2 + nn], af[mt], b[nn]);",
        "acc[mt][2 * n2 + nn][0] += __uint_as_float((af[mt][0] ^ af[mt][1] ^ "
        "af[mt][2] ^ af[mt][3] ^ b[nn][0].x ^ b[nn][P - 1].y) & "
        "0x007fffffu);"),
    "no_mask_reads": (
        "fa[item * 32 + lane] = (mt & 1) ? build_a<1>(y) : build_a<0>(y);",
        "fa[item * 32 + lane] = make_uint4(0x3F803F80u, 0x3F803F80u, "
        "0x3F803F80u, 0x3F803F80u);"),
    "gbits_slices_unrolled": (
        "#pragma unroll 1\n    for (int kk = 0; kk < GB_KS / 16; ++kk) {",
        "#pragma unroll\n    for (int kk = 0; kk < GB_KS / 16; ++kk) {"),
    "no_gbits_compute": (
        "#pragma unroll 1\n    for (int kk = 0; kk < GB_KS / 16; ++kk) {",
        "#pragma unroll 1\n    for (int kk = 0; kk < 0; ++kk) {"),
    "no_gbits_stage_barrier": (
        "    // A in; every warp done with stage s - 1, its ring slot free.\n"
        "    __syncthreads();",
        "    // A in; every warp done with stage s - 1, its ring slot free.\n"),
    "no_gbits_dcur_reads": (
        "const int b = z * a.B + sh.b0 + 16 * (sq % sh.C);",
        "const int b = z * a.B + 16 * (sq % sh.C) * 0;"),
    "no_chain_rec_product": (
        "mma_split_a<P>(rec[n], da, s_wrec, kk * (HP / 8) + MMA_NT * wu + n,\n"
        "                         lane);",
        "rec[n][0] += 0.f;"),
    "no_chain_out_product": (
        "mma_split_a<P>(dz[n], sa, s_wout, MMA_NT * wu + n, lane);",
        "dz[n][0] += 0.f;"),
}
# The wide chain's variants where it runs the cluster body
# (csrc/rec_mma.cuh:rec_mma_chain_kernel), and where it does not.
WIDE_VARIANTS = {  # name -> ((statement, its replacement), ...)
    "no_chain_rec_product": ((
        "mma_split_a<P>(rec[n], da, s_w, kk * NU + NT * wu + n, lane);",
        "rec[n][0] += 0.f;"),),
    "no_chain_exchange": (
        ("    if (s > 0)\n      mbar_wait_cluster(s_full + rb, (NB == 2 ? "
         "(s - 1) >> 1 : s - 1) & 1);\n", ""),
        ("if (NB == 2 && tid == 0 && t > 0) mbar_expect(s_full + wb, "
         "step_bytes);", ""),
        ("if (tid == 0 && t > 0) mbar_expect(s_full, step_bytes);", ""),
        ("copy_to_peer(peer_addr(src + p * plane, peer), src + p * plane,\n"
         "                       1024, peer_addr(bar, peer));", ";")),
    "no_chain_loads": (
        ("gz[n][hh] = load_raw(g_z + at, vec, two);",
         "gz[n][hh] = raw_pair<W>{};"),
        ("rv[n][hh] = load_raw(res + at, vec, two);",
         "rv[n][hh] = raw_pair<W>{};"),
        ("zv[n][hh] = load_raw(z_tr + (t > 0 && ok ? at - stride : 0), vec, "
         "two);", "zv[n][hh] = raw_pair<W>{};")),
    "chain_two_buffers": ((
        "waves * (c.R > 64 ? c.R : 64) * (c.NB == 1 ? 5 : 4);",
        "waves * (c.R > 64 ? c.R : 64) * (c.NB == 1 ? 500 : 4);"),),
    "cuda_core_chain": ((
        "const bool cluster = !chain || bf16;",
        "const bool cluster = !chain;"),),
}
# The deep and two-layer backwards' variants (fused_mid_bwd.cu,
# fused2_bwd.cu): name -> ((statement, its replacement), ...).
MID_VARIANTS = {
    "per_unit_chain": (("p->mma = chain_mma_fits(H, O, rec, bf16, "
                        "lim.max_smem);", "p->mma = 0;"),),
}
TWO_VARIANTS = {
    "per_unit_chain": (("p->mma = chain_mma_fits(H2, O, rec, bf16, "
                        "lim.max_smem) &&", "p->mma = 0 &&"),),
}
CUDA_CORE_VARIANTS = {
    "cluster_chain": ((
        "const bool cluster = !chain || bf16;",
        "const bool cluster = true;"),),
}
BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12  # H100 SXM


def _port_functions() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for src in _build._CSRC.glob("*.cu*"):
        names.update(re.findall(r"(\w+_kernel)\s*\(", src.read_text()))
    return names


def _function_name(key: str) -> str:
    """A profiler kernel name without return type, namespace, template
    arguments and parameters."""
    key = re.sub(r"^void\s+", "", key).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key, maxsplit=1)[0]


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
    """Median device ms of each of the port's ``__global__`` functions
    that ``fn`` launches, over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    ours = _port_functions()
    times: dict = {}
    for _ in range(n):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per: dict = {}
        for ev in prof.key_averages():
            name = _function_name(ev.key)
            if name in ours:
                per[name] = per.get(name, 0.0) + \
                    ev.self_device_time_total / 1e3
        for k, v in per.items():
            times.setdefault(k, []).append(v)
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


def _stacked_ms(a, b, S):
    """``a^T @ b`` as one ``torch.bmm`` over ``S`` stacked copies."""
    sa = a.T.unsqueeze(0).expand(S, -1, -1).contiguous()
    sb = b.unsqueeze(0).expand(S, -1, -1).contiguous()
    ms = _events_ms(lambda: torch.bmm(sa, sb))
    del sa, sb
    torch.cuda.empty_cache()
    return ms


def _bound(nbytes, ops, flops):
    tb, to = nbytes / BYTES_PER_S * 1e3, ops / flops * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _library(lat, delta, tstar, g_logits, dcur, kappa, periodic, md,
             replicas):
    """Each gradient function's one PyTorch call on materialised operands
    (rows (b, t) of the batch; with ``replicas`` also as one ``bmm`` over
    that many stacked copies) and its bound."""
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
        "gbits_mma": _events_ms(lambda: zpf.T @ d),
        "bwd_gout": {"z^T @ s_r": _events_ms(lambda: zf.T @ s_r),
                     "s.sum": _events_ms(lambda: s_flat.sum(0))},
    }
    if replicas:
        out[f"bmm x{replicas}"] = {
            "bwd_gwin": _stacked_ms(raster, d, replicas),
            "gbits_mma": _stacked_ms(zpf, d, replicas),
            "bwd_gout z^T @ s_r": _stacked_ms(zf, s_r, replicas)}
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
    pieces = 3 if md == torch.float32 else 1
    bound = {
        "bwd_gwin": _bound(B * T * H * es + B * F * 4 + F * H * 4, gwin_ops,
                           F32_FLOPS),
        "gbits_mma": _bound(B * T * H * es + B * (T + 1) * ((H + 31) // 32)
                            * 4 + H * H * 4, 2 * B * T * H * H * pieces,
                            BF16_FLOPS),
        "bwd_gout": _bound(B * (T + 1) * ((H + 31) // 32) * 4 + 2 * B * O * 4
                           + (H * O + O) * 4, hidden * O + B * T * O,
                           F32_FLOPS),
    }
    return out, bound


def wide(md, library: bool) -> None:
    """``rec_scan_bwd``'s functions at 784 -> ALIF-512 -> 10, B = 8192, T =
    100 (currents 0.3 + 0.6 N(0, 1) and a masked W_rec of std 1.3 /
    sqrt(H), numpy seed 1, as ``chip_smoke.py``'s wide phase: 10-20 % of
    unit-steps fire), and with ``library`` its ``g_W_rec``'s one PyTorch
    call ``z_prev^T @ round(g_i)`` on materialised ``(T B, 512)`` operands
    and its bound."""
    B, H, T = 8192, 512, 100
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=H,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=T)
    (_, lcfg), _ = cfg.layer_configs
    rng = np.random.default_rng(1)

    def normal(shape, std, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape))
                                .astype(np.float32)).cuda()

    cur = normal((T, B, H), 0.6, 0.3)
    w_rec = (normal((H, H), 1.3 / np.sqrt(H))
             * (1 - torch.eye(H, device="cuda"))).to(md).contiguous()
    beta = 1.6
    z, res, a_tr = rec_scan._fwd_cuda(cur, w_rec, beta, True, lcfg.alpha,
                                      lcfg.rho, lcfg.threshold, True, False,
                                      False)
    del cur
    g_z = (normal((T, B, H), 1.0) / B).to(md)
    out: dict = {}

    def run():
        out["g_i"] = rec_scan._bwd_cuda(
            g_z, z, res, a_tr, False, w_rec, beta, lcfg.alpha,
            lcfg.threshold, lcfg.gamma, lcfg.spike_func)[0]

    tag = {"wide": True, "matmul_dtype": str(md).split(".")[1],
           "firing": float(z.float().mean())}
    print(json.dumps({"variant": "kernel", **tag, "ms": _function_ms(run)}),
          flush=True)
    source = _build.inlined_source("rec_scan")
    if "rec_mma_chain_kernel" in source:  # a tree with the cluster body
        on_cluster = rec_scan.rec_bodies(
            T, H, itemsize=md.itemsize)[1] == "mma"
        variants = {}
        for name, pairs in (WIDE_VARIANTS if on_cluster
                            else CUDA_CORE_VARIANTS).items():
            variant = source
            for old, new in pairs:
                if variant.count(old) != 1:
                    raise SystemExit(f"{name}: statement not found once in "
                                     "the source")
                variant = variant.replace(old, new)
            variants[name] = variant
        with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant
            paths = dict(zip(variants, pool.map(
                _variant_so, [f"rec_{n}" for n in variants],
                variants.values())))
        kernel = _build.load("rec_scan")
        try:
            for name, path in paths.items():
                _build._libs["rec_scan"] = ctypes.CDLL(str(path))
                print(json.dumps({"variant": name, **tag,
                                  "ms": _function_ms(run)}), flush=True)
        finally:
            _build._libs["rec_scan"] = kernel
        plans = rec_scan.cluster_plans(T, H, B, itemsize=md.itemsize)
        print(json.dumps({"plans": plans, **tag}), flush=True)
    if "rec_mma_chain_kernel" in source and on_cluster:
        # One cluster's rows alone: the chain's step latency, T steps.
        R = plans["chain"]["rows"]
        one = [x[:, :R].contiguous() for x in (g_z, z, res)]
        print(json.dumps({"one_cluster_ms": _events_ms(
            lambda: rec_scan._bwd_cuda(
                one[0], one[1], one[2], None, False, w_rec, beta,
                lcfg.alpha, lcfg.threshold, lcfg.gamma, lcfg.spike_func)),
            "rows": R, **tag}), flush=True)
    if not library:
        return
    print(json.dumps({"whole_call_ms": _events_ms(run), **tag}), flush=True)
    zp = torch.cat([torch.zeros_like(z[:1]), z[:-1]]).reshape(T * B, H)
    gi = out.pop("g_i").to(md).reshape(T * B, H)
    pieces = 3 if md == torch.float32 else 1
    lib = {"g_W_rec z_prev^T @ round(g_i)": _events_ms(lambda: zp.T @ gi)}
    bound = {"g_W_rec": _bound(T * B * H * 4 + T * B * ((H + 31) // 32) * 4
                               + H * H * 4, 2 * T * B * H * H * pieces,
                               BF16_FLOPS)}
    print(json.dumps({"library_ms": lib, "bound": bound, **tag}), flush=True)


def izh_bwd(md, periodic: bool) -> None:
    """``--izh``: ``fused_izh_bwd``'s functions on one training batch of the
    Izhikevich network (residuals of ``fused_izh_fwd_train``), as built,
    without each of the chain's two products, and with the per-unit
    chain."""
    from .fit_check import SHAPE_TESTS

    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.Izhikevich,
                    use_recurrent_connection=True, int_time_steps=100,
                    dt=30.0)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    B = 8192
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, 784), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, ro = params["input"], params["readout"]
    kp = izh.izh_kernel_params(lcfg)
    w_in = p0["w_in"].to(md).contiguous()
    w_rec = masked_recurrent(lcfg, p0).to(md).contiguous()
    w_out = ro["w_in"].to(md).contiguous()
    _, v, tstar, _ = fused_izh._head_cuda(
        lat, w_in, w_rec, w_out, ro["b"].contiguous(), 100, periodic, kp,
        rcfg.kappa, True, False)
    g_logits = torch.full((B, 10), 1.0 / B, device="cuda")

    def run():
        fused_izh._bwd_cuda(g_logits, None, tstar, None, None, v, lat, w_in,
                            w_rec, w_out, 100, periodic, kp, lcfg.gamma,
                            rcfg.kappa, lcfg.spike_func)

    source = _build.inlined_source("fused_izh_bwd")
    variants = {"per_unit_chain": SHAPE_TESTS["fused_izh_bwd"]}
    for name in ("no_chain_rec_product", "no_chain_out_product"):
        variants[name] = VARIANTS[name]
    for name, (old, new) in variants.items():
        if source.count(old) != 1:
            raise SystemExit(f"{name}: statement not found once in the "
                             "source")
        variants[name] = source.replace(old, new)
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant
        paths = dict(zip(variants, pool.map(
            _variant_so, [f"izh_{n}" for n in variants], variants.values())))
    libs = {"kernel": _build.load("fused_izh_bwd")}
    libs.update({n: ctypes.CDLL(str(p)) for n, p in paths.items()})
    tag = {"izh": True, "matmul_dtype": str(md).split(".")[1],
           "encoding": "periodic" if periodic else "ttfs",
           "firing": float((v >= lcfg.v_peak).float().mean())}
    try:
        for name, lib in libs.items():
            _build._libs["fused_izh_bwd"] = lib  # what fused_izh loads
            print(json.dumps({"variant": name, **tag,
                              "ms": _function_ms(run),
                              "whole_call_ms": _events_ms(run)}), flush=True)
    finally:
        _build._libs["fused_izh_bwd"] = libs["kernel"]
    # The chain's bound: v read and the rounded gi written once, the z bits,
    # g_logits, tstar and the weights; its two dense products per step on
    # tensor cores (six bf16 piece products for float32 weights), and ~24
    # float32 operations per (row, step, unit) at 67 TFLOP/s beside them.
    T, H, O, es = 100, 128, 10, md.itemsize
    nbytes = (B * T * H * (4 + es) + B * (T + 1) * ((H + 31) // 32) * 4
              + 2 * B * O * 4 + (H * H + H * O) * es)
    products = 2 * B * T * H * (H + O) * (6 if md == torch.float32 else 1)
    print(json.dumps({"chain_bound": _bound(nbytes, products, BF16_FLOPS),
                      "chain_elementwise_ms": 24 * B * T * H / F32_FLOPS
                      * 1e3, **tag}), flush=True)


def _variant_libs(name: str, extra: dict) -> dict:
    """The kernel of ``csrc/<name>.cu`` as built and each variant (one
    statement replaced: ``extra``, and the chain body's
    ``no_chain_rec_product``) as a loaded library."""
    source = _build.inlined_source(name)
    variants = dict(extra, no_chain_rec_product=(VARIANTS[
        "no_chain_rec_product"],))
    for v, pairs in variants.items():
        variant = source
        for old, new in pairs:
            if variant.count(old) != 1:
                raise SystemExit(f"{v}: statement not found once in {name}")
            variant = variant.replace(old, new)
        variants[v] = variant
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc a variant
        paths = dict(zip(variants, pool.map(
            _variant_so, [f"{name}_{v}" for v in variants],
            variants.values())))
    libs = {"kernel": _build.load(name)}
    libs.update({v: ctypes.CDLL(str(p)) for v, p in paths.items()})
    return libs


def _run_variants(name: str, libs: dict, runs: dict, tag: dict) -> None:
    """Each of ``runs`` (label -> a call of the kernel, returning its
    gradients) under each library, one JSON line each: the ``__global__``
    functions' ms, the whole call's by CUDA events, and whether its
    gradients are the kernel's bits."""
    def flat(out):
        return [t for t in out if t is not None]

    built: dict = {}
    try:
        for v, lib in libs.items():
            _build._libs[name] = lib  # what the wrappers load
            for label, run in runs.items():
                got = flat(run())
                if v == "kernel":
                    built[label] = got
                same = all(torch.equal(a, b)
                           for a, b in zip(got, built[label]))
                print(json.dumps({"variant": v, "call": label, **tag,
                                  "same_bits": same,
                                  "ms": _function_ms(run),
                                  "whole_call_ms": _events_ms(run)}),
                      flush=True)
    finally:
        _build._libs[name] = libs["kernel"]


def _gzin_library(label, dcur, w, out_dtype, tag) -> None:
    """``gzin_mma`` alone and ``dcur @ w^T`` as one ``torch.matmul`` on
    materialised operands (dcur laid out ``(T, B, K)``, the output ``(T, B,
    N)`` as the kernel writes it), and the bound: dcur read and the output
    written once; 2 B T K N FLOP at 989 TFLOP/s, x6 for float32 weights'
    pieces."""
    from ..ops import fused_mid

    B, T, K = dcur.shape
    N = w.shape[0]
    md = w.dtype
    d_tbk = dcur.transpose(0, 1).contiguous()
    wt = w.T.contiguous()
    lib_ms = _events_ms(lambda: torch.matmul(d_tbk, wt))
    ms = _events_ms(lambda: fused_mid.gzin(dcur, w, out_dtype))
    got = fused_mid.gzin(dcur, w, out_dtype).float()
    want = torch.matmul(d_tbk.float(), wt.float())
    err = float((got - want).abs().max() / want.abs().max())
    pieces = 6 if md == torch.float32 else 1
    nbytes = B * T * K * md.itemsize + N * K * md.itemsize + \
        B * T * N * torch.empty((), dtype=out_dtype).element_size()
    print(json.dumps({"gzin": label, **tag, "gzin_ms": ms,
                      "library_ms": lib_ms, "err_vs_library": err,
                      "bound": _bound(nbytes, 2 * B * T * K * N * pieces,
                                      BF16_FLOPS)}), flush=True)


def _chain_bound(B, T, H, O, md, rec, traces_in, gz_f32=False):
    """A tensor-core chain's bound: ``traces_in`` (T, B, H) traces read in
    the weights' type (the residual, and in the z-layer mode g_z and z), a
    float32 g_z where ``gz_f32`` (fused2's layer 0), dcur written and the
    z bits; its products 2 B T H (H + O) (six bf16 piece products for
    float32 weights) at 989 TFLOP/s."""
    es, n = md.itemsize, B * T * H
    nbytes = (n * es * (traces_in + 1) + n * 4 * int(gz_f32)
              + B * (T + 1) * ((H + 31) // 32) * 4)
    pieces = 6 if md == torch.float32 else 1
    return _bound(nbytes, 2 * n * ((H if rec else 0) + O) * pieces,
                  BF16_FLOPS)


def mid_bwd(md, library: bool) -> None:
    """``--mid``: ``fused_mid_bwd``'s functions in both modes on one training
    batch of the deep network, as built and in each variant."""
    from ..ops import fused_mid

    cfg = SNNConfig(input_size=784, output_size=10,
                    n_hidden_neurons=[128, 128, 96],
                    hidden_layer_type=LayerType.ALIF,
                    use_recurrent_connection=True, learn_beta=True,
                    int_time_steps=100)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    B, T = 8192, 100
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, 784), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    layers = cfg.layer_configs
    ro = params[layers[-1][0]]
    kappa = layers[-1][1].kappa
    w_out = ro["w_in"].detach().to(md).contiguous()
    b_out = ro["b"].detach().contiguous()
    lw = []
    for name, lcfg in layers[:-1]:
        p = params[name]
        lw.append((p["w_in"].detach().to(md).contiguous(),
                   masked_recurrent(lcfg, p).detach().to(md).contiguous(),
                   p["beta"].detach(), lcfg))
    (w0, r0, b0, c), (w1, r1, b1, _), (w2, r2, b2, _) = lw
    sc = (c.alpha, c.rho, c.threshold)
    z0 = fused._layer0_cuda(lat, w0, r0, b0, T, False, True, *sc, True,
                            False, False)[0]
    _, z1, res1, _, _, _ = fused_mid._mid_cuda(
        z0, w1, r1, b1, None, None, T, True, *sc, 0.0, True, False, False,
        False)
    _, _, res2, _, tstar, _ = fused_mid._mid_cuda(
        z1, w2, r2, b2, w_out, b_out, T, True, *sc, kappa, True, False,
        False, False)
    rng = np.random.default_rng(6)
    g_z = (torch.from_numpy(rng.standard_normal(tuple(z1.shape)).astype(
        np.float32)).cuda() / B).to(md)
    g_logits = torch.full((B, 10), 1.0 / B, device="cuda")
    tail = (c.alpha, c.threshold, c.gamma)
    keep_z: dict = {}
    keep_h: dict = {}
    runs = {
        "z": lambda: fused_mid._mid_bwd_cuda(
            None, None, None, g_z, z1, res1, None, False, z0, w1, r1, b1,
            None, T, *tail, 0.0, c.spike_func, keep=keep_z),
        "head": lambda: fused_mid._mid_bwd_cuda(
            g_logits, None, tstar, None, None, res2, None, False, z1, w2, r2,
            b2, w_out, T, *tail, kappa, c.spike_func, keep=keep_h),
    }
    tag = {"mid": True, "matmul_dtype": str(md).split(".")[1]}
    _run_variants("fused_mid_bwd", _variant_libs("fused_mid_bwd",
                                                 MID_VARIANTS), runs, tag)
    H1, H2 = w1.shape[1], w2.shape[1]
    print(json.dumps({"chain_bound": {
        "z": _chain_bound(B, T, H1, 0, md, True, 3),
        "head": _chain_bound(B, T, H2, 10, md, True, 1)},
        "pack_bits_bound": {m: _bound(
            T * B * n * md.itemsize + B * T * ((n + 31) // 32) * 4, 0,
            F32_FLOPS) for m, n in (("z", w1.shape[0]), ("head", H1))},
        **tag}), flush=True)
    if library:
        for run in runs.values():
            run()
        _gzin_library("z", keep_z["dcur"], w1, md, tag)
        _gzin_library("head", keep_h["dcur"], w2, md, tag)


def twolayer_bwd(md, library: bool) -> None:
    """``--twolayer``: ``fused2_bwd``'s functions on one training batch of
    784-ALIF128-ALIF128-10, as built and in each variant."""
    from ..ops import fused2

    cfg = SNNConfig(input_size=784, output_size=10,
                    n_hidden_neurons=[128, 128],
                    hidden_layer_type=LayerType.ALIF,
                    use_recurrent_connection=True, learn_beta=True,
                    int_time_steps=100)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    B, T = 8192, 100
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, 784), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    (n0, c0), (n1, c1), (nl, cl) = cfg.layer_configs
    p0, p1, ro = params[n0], params[n1], params[nl]

    def cast(t):
        return t.detach().to(md).contiguous()

    args = (lat, cast(p0["w_in"]), cast(masked_recurrent(c0, p0)),
            p0["beta"].detach(), cast(p1["w_in"]),
            cast(masked_recurrent(c1, p1)), p1["beta"].detach(),
            cast(ro["w_in"]), ro["b"].detach().contiguous(), T, False, True,
            c0.alpha, c0.rho, c0.threshold, cl.kappa)
    _, d0, a0, d1, a1, tstar, _, _ = fused2._fused2_cuda(*args, True, False,
                                                         False)
    g_logits = torch.full((B, 10), 1.0 / B, device="cuda")
    keep: dict = {}
    runs = {"twolayer": lambda: fused2._fused2_bwd_cuda(
        g_logits, None, None, tstar, d0, a0, d1, a1, lat, args[1], args[2],
        args[3], args[4], args[5], args[6], args[7], T, False, c0.alpha,
        c0.threshold, c0.gamma, cl.kappa, c0.spike_func, keep=keep)}
    tag = {"twolayer": True, "matmul_dtype": str(md).split(".")[1]}
    _run_variants("fused2_bwd", _variant_libs("fused2_bwd", TWO_VARIANTS),
                  runs, tag)
    H1, H2 = args[1].shape[1], args[4].shape[1]
    b1, b0 = (_chain_bound(B, T, H2, 10, md, True, 1),
              _chain_bound(B, T, H1, 0, md, True, 1, gz_f32=True))
    print(json.dumps({"chain_bound": {
        "layer1": b1, "layer0": b0, "both_ms": b1["bound_ms"]
        + b0["bound_ms"]}, **tag}), flush=True)
    if library:
        runs["twolayer"]()
        _gzin_library("dz0", keep["dcur1"], args[4], torch.float32, tag)


def layer0_bwd(md, izh_layer: bool, periodic: bool) -> None:
    """``--layer0 [--izh]``: a first layer's backward on one training batch
    of its deep network (init weights from seed 0, random pixels, B = 8192,
    T = 100), as built and in each variant."""
    from .fit_check import SHAPE_TESTS

    kind = LayerType.Izhikevich if izh_layer else LayerType.ALIF
    cfg = SNNConfig(input_size=784, output_size=10,
                    n_hidden_neurons=[128, 128] if izh_layer
                    else [128, 128, 96], hidden_layer_type=kind,
                    use_recurrent_connection=True, learn_beta=not izh_layer,
                    int_time_steps=100, **({"dt": 30.0} if izh_layer else {}))
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    B, T = 8192, 100
    x = torch.from_numpy(np.random.default_rng(1).random(
        (B, 784), dtype=np.float32)).cuda()
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    name, c = cfg.layer_configs[0]
    p = params[name]
    w_in = p["w_in"].detach().to(md).contiguous()
    w_rec = masked_recurrent(c, p).detach().to(md).contiguous()
    H = w_in.shape[1]
    g_z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (T, B, H)).astype(np.float32)).cuda() / B
    if izh_layer:
        kp = izh.izh_kernel_params(c)
        z, v = fused_izh._layer0_cuda(lat, w_in, w_rec, T, periodic, kp,
                                      True)
        source, traces = "fused_izh_bwd", (g_z, z, v)

        def run():
            return fused_izh._bwd_cuda(None, None, None, g_z, z, v, lat,
                                       w_in, w_rec, None, T, periodic, kp,
                                       c.gamma, 0.0, c.spike_func)
    else:
        spike = c.spike_func
        res_is_v = fused._residual_is_v(True, spike)
        z, res, a_tr = fused._layer0_cuda(
            lat, w_in, w_rec, p["beta"].detach(), T, periodic, True, c.alpha,
            c.rho, c.threshold, True, fused._stores_a(True, spike), res_is_v)
        g_z = g_z.to(md)
        source, traces = "fused_layer0_bwd", (g_z, z, res, a_tr)

        def run():
            return fused._layer0_bwd_cuda(
                g_z, z, res, a_tr, res_is_v, lat, w_in, w_rec,
                p["beta"].detach(), T, periodic, c.alpha, c.threshold,
                c.gamma, spike)
    tag = {"layer0": True, "izh": izh_layer,
           "matmul_dtype": str(md).split(".")[1],
           "encoding": "periodic" if periodic else "ttfs",
           "firing": float(z.float().mean())}
    libs = _variant_libs(source, {"per_unit_chain": (
        SHAPE_TESTS["fused_izh_bwd"],)})
    _run_variants(source, libs, {"layer0": run}, tag)
    # The chain's bound: its traces read once (g_z, z, the residual and a;
    # Izhikevich g_z, z, v, all float32), the rounded cotangent and the z
    # bits written; dcur(t+1) @ W_rec^T on tensor cores (six bf16 piece
    # products for float32 weights) at 989 TFLOP/s.
    n = B * T * H
    nbytes = (sum(t.numel() * t.element_size() for t in traces
                  if t is not None) + n * md.itemsize
              + B * (T + 1) * ((H + 31) // 32) * 4 + H * H * md.itemsize)
    pieces = 6 if md == torch.float32 else 1
    print(json.dumps({"chain_bound": _bound(nbytes, 2 * n * H * pieces,
                                            BF16_FLOPS), **tag}), flush=True)


def izh_scan_bwd(md) -> None:
    """``--izh-scan``: ``izh_scan_bwd``'s functions on the deep Izhikevich
    network's second layer, as built and in each variant."""
    from .head_ablation import izh_scan_inputs

    cur, w_rec, kp, c = izh_scan_inputs(md)
    z, v = izh._scan_cuda(cur, w_rec, kp, True)
    T, B, H = z.shape
    g_z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (T, B, H)).astype(np.float32)).cuda() / B

    def run():
        return izh._scan_bwd_cuda(g_z, z, v, w_rec, kp, c.gamma,
                                  c.spike_func)

    tag = {"izh_scan": True, "matmul_dtype": str(md).split(".")[1],
           "firing": float(z.mean())}
    libs = _variant_libs("izh_scan", {"per_unit_chain": ((
        "  p->mma = chain_mma_fits(H, 0, rec, bf16, lim.max_smem);",
        "  p->mma = 0;"),)})
    _run_variants("izh_scan", libs, {"scan": run}, tag)
    # The chain's bound: g_z, z and v (float32) read once, g_i (float32)
    # and the z bits written; round(gi(t+1)) @ W_rec^T on tensor cores (six
    # bf16 piece products for float32 weights) at 989 TFLOP/s.
    n = B * T * H
    nbytes = (4 * n * 4 + B * (T + 1) * ((H + 31) // 32) * 4
              + H * H * md.itemsize)
    pieces = 6 if md == torch.float32 else 1
    print(json.dumps({"chain_bound": _bound(nbytes, 2 * n * H * pieces,
                                            BF16_FLOPS), **tag}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--replicas", type=int, default=0,
                    help="with --library, also time each call as one bmm "
                         "over this many stacked copies")
    ap.add_argument("--wide", action="store_true",
                    help="rec_scan_bwd at 784 -> ALIF-512 -> 10 instead")
    ap.add_argument("--izh", action="store_true",
                    help="fused_izh_bwd at 784 -> Izhikevich-128 -> 10 "
                         "(with --layer0: fused_izh_layer0_bwd)")
    ap.add_argument("--layer0", action="store_true",
                    help="fused_layer0_bwd at layer 0 of 784 -> 128 -> 128 "
                         "-> 96 -> 10")
    ap.add_argument("--mid", action="store_true",
                    help="fused_mid_bwd at 784 -> 128 -> 128 -> 96 -> 10")
    ap.add_argument("--twolayer", action="store_true",
                    help="fused2_bwd at 784 -> ALIF-128 -> ALIF-128 -> 10")
    ap.add_argument("--izh-scan", action="store_true",
                    help="izh_scan_bwd at layer 1 of 784 -> Izhikevich-128 "
                         "-> Izhikevich-128 -> 10")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablation needs a CUDA card")
    md = getattr(torch, ns.matmul_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    if ns.wide:
        wide(md, ns.library)
        _print_card()
        return
    if ns.layer0:
        layer0_bwd(md, ns.izh, ns.periodic)
        _print_card()
        return
    if ns.izh_scan:
        izh_scan_bwd(md)
        _print_card()
        return
    if ns.izh:
        izh_bwd(md, ns.periodic)
        _print_card()
        return
    if ns.mid or ns.twolayer:
        (mid_bwd if ns.mid else twolayer_bwd)(md, ns.library)
        _print_card()
        return
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
                                 rcfg.kappa, ns.periodic, md, ns.replicas)
        print(json.dumps({"library_ms": lib_ms, "bound": bound, **tag}),
              flush=True)
    _print_card()


def _print_card() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
