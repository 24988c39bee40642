"""Where the head kernel's time goes: time ``csrc/fused_head.cu`` with one
piece of work removed at a time, on the served flagship batch.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.head_ablation
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation \
        --launch-order
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation --bodies
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation --izh \
        [--bodies]
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation --wide
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation --mid
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation \
        --twolayer
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation --layer0
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation \
        --izh-scan

Each variant is the kernel source (headers inlined) with one statement of
its tensor-core body replaced: the readout product, the recurrent product,
or a step's input sum (the dense product of a dense step and the rows'
gathers, the sort kept); variants that remove work change the dynamics, so
only their times mean anything.  The
batch is the one ``chip_smoke.py`` serves: 4096 random uint8 rows of the
flagship (784 -> ALIF-128 recurrent, learn_beta, T=100, TTFS, production
tau), float32 weights.  Prints one JSON line per variant and round
(median of 20 launches by CUDA events) and the card's name and power
limit.  Builds go to ``.torch_ext_build/ablation/``.

``--bodies`` times the kernel's two bodies on that batch, the tensor-core
body as built and the per-unit body (the source with the tensor-core
body's shape test made false, ``tools/fit_check.py``), float32 and
bfloat16, TTFS and periodic, at the production tau and at tau = 20 steps
(latencies spread over the window, as ``chip_smoke.py`` phase 3 draws
them).

``--izh`` does the same for the Izhikevich head (``csrc/fused_izh.cu``,
the same tensor-core body with the Izhikevich cell): 784 -> Izhikevich-128
recurrent -> 10 at dt = 30 (the served network of ``chip_smoke.py`` phase
9, seed 0) on the same batch; ``--izh --bodies`` its two bodies.

``--wide`` times the wide net's recurrent scan forward instead
(``csrc/rec_scan.cu``, 784 -> ALIF-512 -> 10: ``rec_scan_fwd_train`` at B
= 8192 and ``rec_scan_fwd`` at 4096, T = 100, currents 0.3 + 0.6 N(0, 1)
and a masked W_rec of std 1.3 / sqrt(H), numpy seed 1, as
``chip_smoke.py``'s wide phase), float32 and bfloat16, on its tensor-core
cluster body as built and without its recurrent product
(``no_recurrent_product``), without the exchange of the spike words
(``no_exchange``: no copies into the peers and no wait on them), without
the currents' loads (``no_cur_loads``: a constant), without the traces'
global stores (``no_trace_stores``), and on the CUDA-core body
(``cuda_core_body``: the cluster plans made not to fit); then the plans
(clusters of C blocks, clusters active at once) and each body's time on
one cluster's rows alone (``one_cluster``: the step's latency, T steps).

``--mid`` times the deep net's mid-layer forward (``csrc/fused_mid.cu``,
784-ALIF128-ALIF128-ALIF96-10: the z-emitting 128 -> 128 call and the head
128 -> 96 -> 10 call, training at B = 8192 and served at 4096, float32 and
bfloat16) on its tensor-core body as built, without the input product
(``no_input_product``), without the recurrent product
(``no_recurrent_product``), without the exchange of z and the step's
barrier (``no_exchange``), with W_in's pieces read from L2 instead of
shared memory (``win_from_l2``) and on the per-unit body
(``per_unit_body``); ``--twolayer`` the same for the two-layer forward
(``csrc/fused2.cu``, 784-ALIF128-ALIF128-10; ``no_input_product`` is
layer 1's z0 @ W1, ``w1_from_l2`` W1's pieces from L2 where they fit
shared memory).

``--layer0`` times the first layers' forwards on the head's tensor-core
body without the readout: ``fused_layer0_fwd`` (``csrc/fused_head.cu``,
784 -> ALIF-128 recurrent, learn_beta, the deep network's layer 0:
training TTFS and periodic at B = 8192, served TTFS at 4096) and
``fused_izh_layer0_fwd`` (``csrc/fused_izh.cu``, 784 -> Izhikevich-128
recurrent at dt = 30, training TTFS at 8192), params seed 0, random uint8
rows (numpy seed 1; periodic also at tau = 20 steps, where every row walks
its periods a step), float32 and bfloat16: as built (z(t) leaves from the
tile's exchange buffer in 16-byte stores), with each lane storing its pair
of z values from the accumulator layout instead (``per_lane_z``), with no
z store (``no_z_store``), with the launch bound of the threads alone
(``ptxas_heuristic``: ptxas then held some instances to 128 registers and
spilled) and on the per-unit body (``per_unit_body``).

``--izh-scan`` times ``izh_scan_fwd`` (``csrc/izh_scan.cu``) on the
deep Izhikevich network's second layer (784-Izh128-Izh128-10 at dt = 30,
params seed 0: its currents z0 @ W1, z0 from ``fused_izh_layer0_fwd`` on
8192 random uint8 rows, numpy seed 1, TTFS), training at B = 8192 and
inference on the first 4096 rows, float32 and bfloat16: as built (the
first layers' tensor-core body with the currents as its input) and on the
per-unit body (``per_unit_body``: the scan's plan made not to take the
tensor-core body).

``--launch-order`` times the stacked kernel (six replicas of that
flagship, seeds 0-5, on the same batch) as it is built, row tiles on the
grid's fastest axis, against a variant with the replicas there; the two
must give equal logits.
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
from ..ops import _build, fused, fused_izh, izh
from ..ops.cells import masked_recurrent
from ..ops.encoding import pixels_to_firing_periods

VARIANTS = {  # name -> (statement of the kernel's source, its replacement)
    "no_readout_product": (
        "mma_exact_a<P>(ro[jo], A, s_wout, kk * 2 + wu + jo * NWU, lane);",
        "ro[jo][0] += 0.f;"),
    "no_recurrent_product": (
        "mma_exact_a<P>(rec[n], A, s_wrec,\n"
        "                           kk * (HP / 8) + MMA_NT * wu + n, lane);",
        "rec[n][0] += 0.f;"),
    # A step's input sum, the dense product and the rows' gathers (the
    # sort and the every-step sum kept).
    "no_input": (
        "    if (__any_sync(0xffffffffu, dense[0] || dense[1]))\n"
        "      dense_input<P>(cur, lat, F, row0, dense, w_in, H, lane, wu,\n"
        "                     [=](int L) { return L == t; });\n"
        "#pragma unroll\n"
        "    for (int hh = 0; hh < 2; ++hh)\n"
        "      if (!dense[hh])\n"
        "        step_runs(lrow[hh], FA, nk[hh], cursor[hh], next[hh], t, "
        "periodic,\n"
        "                  [&](int k, int e) {\n"
        "                    gather_rows(cur, hh, w_in, H, col0, lrow[hh], "
        "k, e);\n"
        "                  });\n",
        ""),
}

# The wide forward's variants (csrc/rec_mma.cuh:rec_mma_fwd_kernel).
WIDE_VARIANTS = {
    "no_recurrent_product": (
        ("mma_exact_a<P>(rec[n], A, s_w, kk * NU + MMA_NT * wu + n, lane);",
         "rec[n][0] += 0.f;"),),
    "no_exchange": (
        ("if (t > 0) mbar_wait_cluster(s_full + ((t - 1) & 1), ((t - 1) >> 1) "
         "& 1);", ""),
        ("if (tid == 0 && t < T - 1) mbar_expect(s_full + (t & 1), "
         "step_bytes);", ""),
        ("copy_to_peer(peer_addr(src, p), src, 64, peer_addr(bar, p));",
         ";")),
    "no_cur_loads": (
        ("cur[n][hh] = load_raw(a.cur + (ok ? at : 0), vec, col + 1 < H);",
         "cur[n][hh] = make_float2(0.3f, 0.3f);"),),
    "no_trace_stores": (
        ("if (!live[hh] || col >= H) continue;",
         "if (!live[hh] || col >= H || t >= 0) continue;"),),
    "cuda_core_body": (
        ("(chain ? p->chain_mma : p->fwd_mma) = rc == 0;",
         "(chain ? p->chain_mma : p->fwd_mma) = false;"),),
}

# The named barrier of the tensor-core bodies (head_mma.cuh:tile_sync).
NO_BARRIER = ('  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(n) : '
              '"memory");', "")

# The mid layer's variants (csrc/fused_mid.cu:mid_mma_kernel).
MID_VARIANTS = {
    "no_input_product": (
        ("    if (t + 1 < T)\n"
         "      mask_product<P>(cin, s_m + ((t + 1) & 1) * 16 * NW, NW, KI, "
         "win, HP / 8,\n                      wu, lane);\n", ""),),
    "no_recurrent_product": (
        ("            mma_exact_a<P>(rec[n], A, s_wrec,\n"
         "                           kk * (HP / 8) + MMA_NT * wu + n, lane);",
         "            rec[n][0] += 0.f;"),),
    "no_exchange": (
        ("    if (REC || HEAD) put_slice(s_z + (t & 1) * 16 * ZS, ZS, wu, "
         "lane, zf);", ""), NO_BARRIER),
    "win_from_l2": (
        ("  for (int w = 1; w >= 0; --w) {\n    if (mid_mma_layout(",
         "  for (int w = 0; w >= 0; --w) {\n    if (mid_mma_layout("),),
    "per_unit_body": (
        ("  out[0] = mid_mma_fits(Hin, H, O, rec, bf16, max_smem, &win) ? 1 "
         ": 0;", "  out[0] = 0;"),),
}

# The two-layer pair's variants (csrc/fused2.cu:fused2_mma_kernel).
TWOLAYER_VARIANTS = {
    "no_input_product": (
        ("        mma_exact_a<P>(cur[n], A, w1f, kk * (HP / 8) + MMA_NT * wu + "
         "n, lane);", "        cur[n][0] += 0.f;"),),
    "no_recurrent_product": (
        ("            mma_exact_a<P>(rec[n], A, s_wrec,\n"
         "                           kk * (HP / 8) + MMA_NT * wu + n, lane);",
         "            rec[n][0] += 0.f;"),
        ("            mma_exact_a<P>(rec[n], A, s_w1r, kk * (HP / 8) + MMA_NT "
         "* wu + n,\n                           lane);", "            "
         "rec[n][0] += 0.f;")),
    "no_exchange": (
        ("    put_slice(s_z + (t & 1) * 16 * ZS, ZS, wu, lane, zf);", ""),
        ("    put_slice(s_z1 + (s & 1) * 16 * ZS, ZS, wu, lane, zf);", ""),
        NO_BARRIER),
    "w1_from_l2": (
        ("  for (int w = 1; w >= 0; --w) {\n    if (mma2_layout(",
         "  for (int w = 0; w >= 0; --w) {\n    if (mma2_layout("),),
    "per_unit_body": (
        ("  out[0] = mma2_fits(F, H1, H2, O, rec, bf16, max_smem, &w1s) ? 1 "
         ": 0;", "  out[0] = 0;"),),
}

# The first layers' variants (csrc/head_mma_fwd.cuh:mma_layer without the
# readout): z(t) stored by each lane from the accumulator layout, a pair of
# units a store, as the cell step makes it (instead of from the tile's
# exchange buffer in 16-byte stores after the step's barrier); no z store;
# the kernel's launch bound; the per-unit body (the first layer's plan made
# not to take the tensor-core body).
Z_FROM_BUFFER = (
    ("    if (ZOUT && zo && t > 0)\n"
     "      zst.put(zo + ((size_t)(t - 1) * B + row0) * H,\n"
     "              s_z + ((t - 1) & 1) * 16 * ZS);\n", ""),
    ("  if (ZOUT && zo)  // z(T - 1): its buffer is written no more\n"
     "    zst.put(zo + ((size_t)(T - 1) * B + row0) * H,\n"
     "            s_z + ((T - 1) & 1) * 16 * ZS);\n", ""))
LAYER0_VARIANTS = {
    "per_lane_z": Z_FROM_BUFFER + (
        ("        zf[n][e] = z ? 1.f : 0.f;\n",
         "        zf[n][e] = z ? 1.f : 0.f;\n"
         "        if (ZOUT && zo && (e & 1) && live[e >> 1] && "
         "col0 + 8 * n < H)\n"
         "          store_pair(zo + ((size_t)t * B + row0 + g + 8 * (e >> 1))"
         " * H + col0 + 8 * n,\n"
         "                     zf[n][e - 1], zf[n][e], col0 + 8 * n + 1 < H);"
         "\n"),),
    "no_z_store": Z_FROM_BUFFER,
    # The bound the kernel had: the threads alone, from which ptxas held
    # some instances to 128 registers and spilled.
    "ptxas_heuristic": (
        ("__global__ void __launch_bounds__(MMA_THREADS, 1)\n"
         "    head_mma_kernel(",
         "__global__ void __launch_bounds__(MMA_THREADS)\n"
         "    head_mma_kernel("),),
    "per_unit_body": (
        ("  *mma_out = mma_fits(H, O, rec, bf16, max_smem) ? 1 : 0;",
         "  *mma_out = O > 0 && mma_fits(H, O, rec, bf16, max_smem) ? 1 : 0;"),),
}

# izh_scan_fwd on its per-unit body (the scan's plan made not to take the
# tensor-core body).
IZH_SCAN_VARIANTS = {
    "per_unit_body": (
        ("  *mma_out = mma_fits(H, 0, rec, bf16, max_smem) ? 1 : 0;",
         "  *mma_out = 0;"),),
}

# The stacked launch with its grid's axes swapped: replicas on x (fastest),
# row tiles on y.
LAUNCH_ORDER = (
    ("const int row0 = (blockIdx.x * tpb + tile) * 16;\n  if (row0 >= B) "
     "return;  // a tile past the batch",
     "const int row0 = (blockIdx.y * tpb + tile) * 16;\n  if (row0 >= B) "
     "return;  // a tile past the batch"),
    ("unsigned char smem[];\n  const FwdArgs<typename Cell::Params> a = "
     "at_replica<W>(a0, blockIdx.y);",
     "unsigned char smem[];\n  const FwdArgs<typename Cell::Params> a = "
     "at_replica<W>(a0, blockIdx.x);"),
    ("kernel<<<dim3((tiles + tpb - 1) / tpb, S),",
     "kernel<<<dim3(S, (tiles + tpb - 1) / tpb),"),
)


def _variant_lib(name: str, source: str) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _median_ms(fn, n: int = 20) -> float:
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


def _replace(name: str, source: str, pairs) -> str:
    for old, new in pairs:
        if source.count(old) != 1:
            raise SystemExit(f"{name}: statement {old!r} not found once in "
                             "the source")
        source = source.replace(old, new)
    return source


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_bodies(args: dict, x: torch.Tensor, src: str, call) -> None:
    """One JSON line per (dtype, encoding, tau): both bodies' median ms of
    ``call(args)`` (the kernel of ``csrc/<src>.cu``), the per-unit body's
    first, then the tensor-core body's, then again."""
    from .fit_check import _per_unit_lib

    libs = {"per-unit": _per_unit_lib(src), "mma": _build.load(src)}
    tau = {"production": 20e-3, "spread": 20.0}
    try:
        for md in (torch.float32, torch.bfloat16):
            for periodic in (False, True):
                for tau_name, tau_v in tau.items():
                    a = dict(args, use_periods=periodic,
                             latencies=pixels_to_firing_periods(
                                 x, t_max=100.0, tau=tau_v).contiguous(),
                             **{k: args[k].to(md) for k in
                                ("w_in", "w_rec", "w_out")})
                    ms = {}
                    for rnd in range(2):
                        for name, lib in libs.items():
                            _build._libs[src] = lib
                            ms.setdefault(name, []).append(_median_ms(
                                lambda: call(a)))
                    print(json.dumps({"dtype": str(md)[6:],
                                      "periodic": periodic, "tau": tau_name,
                                      "ms": ms}), flush=True)
    finally:
        _build._libs[src] = libs["mma"]
    print(_card())


def _izh_args(x: torch.Tensor) -> dict:
    """The Izhikevich network's head arguments on the batch ``x``:
    784 -> Izhikevich-128 recurrent -> 10, T = 100, dt = 30, seed 0, TTFS
    at the production tau, float32."""
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.Izhikevich,
                    use_recurrent_connection=True, int_time_steps=100,
                    dt=30.0)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, ro = params["input"], params["readout"]
    return dict(latencies=pixels_to_firing_periods(x, t_max=100.0)
                .contiguous(), w_in=p0["w_in"].contiguous(),
                w_rec=masked_recurrent(lcfg, p0).contiguous(),
                w_out=ro["w_in"].contiguous(), b_out=ro["b"].contiguous(),
                kernel_params=izh.izh_kernel_params(lcfg), n_steps=100,
                use_periods=False, gamma=lcfg.gamma, kappa=rcfg.kappa)


def _izh_call(a: dict) -> torch.Tensor:
    return fused_izh.fused_encode_izh_scan_head(
        a["latencies"], a["w_in"], a["w_rec"], a["w_out"], a["b_out"],
        a["kernel_params"], a["n_steps"], a["use_periods"], a["gamma"],
        a["kappa"])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launch-order", action="store_true",
                        help="time the stacked kernel's two grid orders")
    parser.add_argument("--bodies", action="store_true",
                        help="time the tensor-core and per-unit bodies")
    parser.add_argument("--izh", action="store_true",
                        help="the Izhikevich head (csrc/fused_izh.cu)")
    parser.add_argument("--wide", action="store_true",
                        help="the wide net's recurrent scan forward "
                             "(csrc/rec_scan.cu)")
    parser.add_argument("--mid", action="store_true",
                        help="the deep net's mid-layer forward "
                             "(csrc/fused_mid.cu)")
    parser.add_argument("--twolayer", action="store_true",
                        help="the two-layer forward (csrc/fused2.cu)")
    parser.add_argument("--layer0", action="store_true",
                        help="the first layers' forwards (csrc/fused_head.cu"
                             ", csrc/fused_izh.cu)")
    parser.add_argument("--izh-scan", action="store_true",
                        help="the Izhikevich scan's forward "
                             "(csrc/izh_scan.cu)")
    ns = parser.parse_args()
    launch_order = ns.launch_order
    if not torch.cuda.is_available():
        raise SystemExit("head_ablation needs a CUDA card")
    if ns.wide:
        _wide_main()
        return
    if ns.mid or ns.twolayer:
        _layers_main("fused_mid" if ns.mid else "fused2")
        return
    if ns.layer0:
        _layer0_main()
        return
    if ns.izh_scan:
        _izh_scan_main()
        return
    if ns.izh:
        _izh_main(ns.bodies)
        return
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=100)
    seeds = range(6) if launch_order else range(1)
    params = [model_lib.init(cfg, torch.Generator().manual_seed(s),
                             device="cuda") for s in seeds]
    raw = np.random.default_rng(1).integers(0, 256, (4096, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    (_, lcfg), (_, rcfg) = cfg.layer_configs

    def stack(f):  # one replica's tensor, or the replicas' stacked
        out = [f(p["input"], p["readout"]) for p in params]
        return (torch.stack(out) if launch_order else out[0]).contiguous()

    args = dict(
        latencies=pixels_to_firing_periods(x, t_max=100.0).contiguous(),
        w_in=stack(lambda p0, pr: p0["w_in"]),
        w_rec=stack(lambda p0, pr: masked_recurrent(lcfg, p0)),
        beta=stack(lambda p0, pr: p0["beta"].reshape(())),
        w_out=stack(lambda p0, pr: pr["w_in"]),
        b_out=stack(lambda p0, pr: pr["b"]),
        n_steps=100, use_periods=False, alif=True, alpha=lcfg.alpha,
        rho=lcfg.rho, threshold=lcfg.threshold, gamma=lcfg.gamma,
        kappa=rcfg.kappa)
    if ns.bodies:
        _time_bodies(args, x, "fused_head",
                     lambda a: fused.fused_encode_rec_scan_head(**a))
        return
    source = _build.inlined_source("fused_head")
    libs = {"kernel": _build.load("fused_head")}
    variants = ({"replica_fastest": LAUNCH_ORDER} if launch_order
                else {k: (v,) for k, v in VARIANTS.items()})
    for name, pairs in variants.items():
        libs[name] = _variant_lib(name, _replace(name, source, pairs))
    card = _card()
    try:
        if launch_order:
            logits = {}
            for name, lib in libs.items():
                _build._libs["fused_head"] = lib
                logits[name] = fused.fused_encode_rec_scan_head(**args)
            if not torch.equal(*logits.values()):
                raise SystemExit("the two launch orders give different "
                                 "logits")
            print(json.dumps({"equal_logits": True, "shape":
                              list(logits["kernel"].shape)}), flush=True)
        for rnd in range(2):
            for name, lib in libs.items():
                _build._libs["fused_head"] = lib  # what fused._lib() loads
                ms = _median_ms(
                    lambda: fused.fused_encode_rec_scan_head(**args))
                print(json.dumps({"variant": name, "round": rnd, "ms": ms}),
                      flush=True)
    finally:
        _build._libs["fused_head"] = libs["kernel"]
    print(card)


def _izh_main(bodies: bool) -> None:
    """``--izh``: the Izhikevich head's variants (or, with ``bodies``, its
    two bodies) on the served batch."""
    raw = np.random.default_rng(1).integers(0, 256, (4096, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    args = _izh_args(x)
    if bodies:
        _time_bodies(args, x, "fused_izh", _izh_call)
        return
    source = _build.inlined_source("fused_izh")
    libs = {"kernel": _build.load("fused_izh")}
    for name, pair in VARIANTS.items():
        libs[name] = _variant_lib(f"izh_{name}",
                                  _replace(name, source, (pair,)))
    card = _card()
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                _build._libs["fused_izh"] = lib  # what fused_izh._lib() loads
                ms = _median_ms(lambda: _izh_call(args))
                print(json.dumps({"variant": name, "izh": True, "round": rnd,
                                  "ms": ms}), flush=True)
    finally:
        _build._libs["fused_izh"] = libs["kernel"]
    print(card)


def _wide_main() -> None:
    """``--wide``: the recurrent scan forward's variants at the wide net's
    shapes, float32 and bfloat16, training (B = 8192) and served (4096)."""
    from ..ops import rec_scan

    B, H, T = 8192, 512, 100
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=H,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=T)
    (_, lcfg), _ = cfg.layer_configs
    rng = np.random.default_rng(1)
    cur = torch.from_numpy((0.3 + 0.6 * rng.standard_normal((T, B, H)))
                           .astype(np.float32)).cuda()
    w32 = torch.from_numpy((1.3 / np.sqrt(H) * rng.standard_normal((H, H)))
                           .astype(np.float32)).cuda()
    w32 = w32 * (1 - torch.eye(H, device="cuda"))
    source = _build.inlined_source("rec_scan")
    libs = {"kernel": _build.load("rec_scan")}
    with ThreadPoolExecutor(len(WIDE_VARIANTS)) as pool:  # one nvcc each
        built = pool.map(lambda kv: _variant_lib(
            f"rec_{kv[0]}", _replace(kv[0], source, kv[1])),
            WIDE_VARIANTS.items())
        libs.update(zip(WIDE_VARIANTS, built))
    sc = (1.6, True, lcfg.alpha, lcfg.rho, lcfg.threshold)
    served = cur[:, :4096].contiguous()
    try:
        for md in (torch.float32, torch.bfloat16):
            w = w32.to(md).contiguous()
            R = rec_scan.cluster_plans(T, H, B, itemsize=md.itemsize)[
                "fwd"]["rows"]
            one = cur[:, :R].contiguous()
            calls = {
                "train": lambda: rec_scan._fwd_cuda(cur, w, *sc, True, False,
                                                    False),
                "serve": lambda: rec_scan._fwd_cuda(served, w, *sc, False,
                                                    False, False),
                "one_cluster": lambda: rec_scan._fwd_cuda(
                    one, w, *sc, True, False, False)}
            for rnd in range(2):
                for name, lib in libs.items():
                    _build._libs["rec_scan"] = lib  # what rec_scan loads
                    ms = {k: _median_ms(f, 5) for k, f in calls.items()}
                    print(json.dumps({"variant": name, "wide": True,
                                      "dtype": str(md)[6:], "round": rnd,
                                      "ms": ms}), flush=True)
            _build._libs["rec_scan"] = libs["kernel"]
            plans = {f"B={b}": rec_scan.cluster_plans(
                T, H, b, itemsize=md.itemsize) for b in (B, 4096)}
            print(json.dumps({"plans": plans, "dtype": str(md)[6:]}),
                  flush=True)
    finally:
        _build._libs["rec_scan"] = libs["kernel"]
    print(_card())


def _time_variants(src: str, variants: dict, calls: dict, tag: dict,
                   n: int = 5) -> None:
    """Build ``csrc/<src>.cu``'s variants (one nvcc each, all at once) and
    print each one's median ms of every call, as built first, two
    rounds."""
    source = _build.inlined_source(src)
    libs = {"kernel": _build.load(src)}
    with ThreadPoolExecutor(len(variants)) as pool:
        built = pool.map(lambda kv: _variant_lib(
            f"{src}_{kv[0]}", _replace(kv[0], source, kv[1])),
            variants.items())
        libs.update(zip(variants, built))
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                _build._libs[src] = lib  # what the wrapper's _lib() loads
                ms = {k: _median_ms(f, n) for k, f in calls.items()}
                print(json.dumps({"variant": name, **tag, "round": rnd,
                                  "ms": ms}), flush=True)
    finally:
        _build._libs[src] = libs["kernel"]


def _layers_main(src: str) -> None:
    """``--mid`` / ``--twolayer``: the variants of the mid layer's forward
    (784-ALIF128-ALIF128-ALIF96-10, its z-emitting 128 -> 128 call on layer
    0's spikes and its head 128 -> 96 -> 10 call on those of the z call) or
    of the two-layer forward (784-ALIF128-ALIF128-10), recurrent, learn_beta,
    T = 100, TTFS, params seed 0, on 8192 random uint8 rows (numpy seed 1)
    for training and their first 4096 served, float32 and bfloat16."""
    from ..ops import fused2, fused_mid

    widths = [128, 128, 96] if src == "fused_mid" else [128, 128]
    raw = np.random.default_rng(1).integers(0, 256, (8192, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    for md in ("float32", "bfloat16"):
        cfg = SNNConfig(input_size=784, output_size=10,
                        n_hidden_neurons=widths,
                        hidden_layer_type=LayerType.ALIF,
                        use_recurrent_connection=True, learn_beta=True,
                        int_time_steps=100, matmul_dtype=md)
        params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        dt = getattr(torch, md)
        layers = cfg.layer_configs
        w = [(params[n]["w_in"].to(dt).contiguous(),
              masked_recurrent(c, params[n]).to(dt).contiguous(),
              params[n]["beta"].detach(), c) for n, c in layers[:-1]]
        ro = params[layers[-1][0]]
        w_out, b_out = ro["w_in"].to(dt).contiguous(), ro["b"].contiguous()
        kappa = layers[-1][1].kappa
        sc = (w[0][3].alpha, w[0][3].rho, w[0][3].threshold)
        if src == "fused2":
            def call(rows, train):
                l_ = lat[:rows]
                return lambda: fused2._fused2_cuda(
                    l_, w[0][0], w[0][1], w[0][2], w[1][0], w[1][1],
                    w[1][2], w_out, b_out, 100, False, True, *sc, kappa,
                    train, False, False)
            calls = {"train": call(8192, True), "serve": call(4096, False)}
        else:
            z0 = fused._layer0_cuda(lat, w[0][0], w[0][1], w[0][2], 100,
                                    False, True, *sc, False, False, False)[0]
            z1 = fused_mid._mid_cuda(z0, w[1][0], w[1][1], w[1][2], None,
                                     None, 100, True, *sc, 0.0, False, False,
                                     False, False)[1]

            def call(z_in, rows, head, train):
                z_in = z_in[:, :rows].contiguous()
                wi, wr, beta, _ = w[2 if head else 1]
                return lambda: fused_mid._mid_cuda(
                    z_in, wi, wr, beta, w_out if head else None,
                    b_out if head else None, 100, True, *sc,
                    kappa if head else 0.0, train, False, False, False)
            calls = {"z_train": call(z0, 8192, False, True),
                     "head_train": call(z1, 8192, True, True),
                     "z_serve": call(z0, 4096, False, False),
                     "head_serve": call(z1, 4096, True, False)}
        variants = MID_VARIANTS if src == "fused_mid" else TWOLAYER_VARIANTS
        _time_variants(src, variants, calls, {src: True, "dtype": md})
    print(_card())


def _layer0_main() -> None:
    """``--layer0``: the variants of both first layers' forwards."""
    raw = np.random.default_rng(1).integers(0, 256, (8192, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    spread = pixels_to_firing_periods(x, t_max=100.0, tau=20.0).contiguous()
    for md in ("float32", "bfloat16"):
        dt = getattr(torch, md)
        cfg = SNNConfig(input_size=784, output_size=10,
                        n_hidden_neurons=[128, 128, 96],
                        hidden_layer_type=LayerType.ALIF,
                        use_recurrent_connection=True, learn_beta=True,
                        int_time_steps=100, matmul_dtype=md)
        params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        name, lcfg = cfg.layer_configs[0]
        p = params[name]
        w_in = p["w_in"].to(dt).contiguous()
        w_rec = masked_recurrent(lcfg, p).to(dt).contiguous()
        beta = p["beta"].detach()
        sc = (True, lcfg.alpha, lcfg.rho, lcfg.threshold)

        def lif(lat_, per, train):
            return lambda: fused._layer0_cuda(lat_, w_in, w_rec, beta, 100,
                                              per, *sc, train, False, False)

        _time_variants("fused_head", LAYER0_VARIANTS, {
            "train": lif(lat, False, True),
            "train_periodic": lif(lat, True, True),
            "train_periodic_tau20": lif(spread, True, True),
            "serve": lif(lat[:4096].contiguous(), False, False)},
            {"layer0": "fused_layer0_fwd", "dtype": md}, n=10)
        icfg = SNNConfig(input_size=784, output_size=10,
                         n_hidden_neurons=[128, 128],
                         hidden_layer_type=LayerType.Izhikevich,
                         use_recurrent_connection=True, int_time_steps=100,
                         dt=30.0, matmul_dtype=md)
        iparams = model_lib.init(icfg, torch.Generator().manual_seed(0),
                                 device="cuda")
        name, lcfg = icfg.layer_configs[0]
        ip = iparams[name]
        l0 = (lat, ip["w_in"].to(dt).contiguous(),
              masked_recurrent(lcfg, ip).to(dt).contiguous(), 100, False,
              izh.izh_kernel_params(lcfg), True)
        _time_variants("fused_izh", LAYER0_VARIANTS, {
            "train": lambda: fused_izh._layer0_cuda(*l0)},
            {"layer0": "fused_izh_layer0_fwd", "dtype": md}, n=10)
    print(_card())


def izh_scan_inputs(md: torch.dtype):
    """The deep Izhikevich network's second layer as ``izh_scan`` takes it
    (784-Izh128-Izh128-10, dt = 30, params seed 0, W_in, W1 and W_rec in
    ``md``): its currents ``z0 @ W1`` (T, B, H) float32, z0 from
    ``fused_izh_layer0_fwd`` on 8192 random uint8 rows (numpy seed 1,
    TTFS), its masked W_rec, kernel params and layer config."""
    raw = np.random.default_rng(1).integers(0, 256, (8192, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    lat = pixels_to_firing_periods(x, t_max=100.0).contiguous()
    cfg = SNNConfig(input_size=784, output_size=10,
                    n_hidden_neurons=[128, 128],
                    hidden_layer_type=LayerType.Izhikevich,
                    use_recurrent_connection=True, int_time_steps=100,
                    dt=30.0)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    (n0, c0), (n1, c1) = cfg.layer_configs[:2]
    p0, p1 = params[n0], params[n1]
    z0 = fused_izh._layer0_cuda(
        lat, p0["w_in"].detach().to(md).contiguous(),
        masked_recurrent(c0, p0).detach().to(md).contiguous(), 100, False,
        izh.izh_kernel_params(c0), False)[0]
    cur = (z0 @ p1["w_in"].detach().to(md).float()).contiguous()
    return (cur, masked_recurrent(c1, p1).detach().to(md).contiguous(),
            izh.izh_kernel_params(c1), c1)


def _izh_scan_main() -> None:
    """``--izh-scan``: ``izh_scan_fwd`` as built and on its per-unit
    body."""
    for md in ("float32", "bfloat16"):
        cur, w_rec, kp, _ = izh_scan_inputs(getattr(torch, md))
        served = cur[:, :4096].contiguous()
        _time_variants("izh_scan", IZH_SCAN_VARIANTS, {
            "train": lambda: izh._scan_cuda(cur, w_rec, kp, True),
            "serve": lambda: izh._scan_cuda(served, w_rec, kp, False)},
            {"izh_scan": "izh_scan_fwd", "dtype": md,
             "firing": float(izh._scan_cuda(cur, w_rec, kp, False)[0]
                             .mean())}, n=10)
    print(_card())


if __name__ == "__main__":
    main()
