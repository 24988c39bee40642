"""Where the backward kernel's time goes: time the four ``__global__``
functions of ``fused_head_bwd`` (``csrc/fused_head_bwd.cu`` over
``csrc/bwd_common.cuh``: the chain, ``g_W_in``, ``bwd_gbits`` for
``g_W_rec``, the readout gradients; at the flagship the chain takes its
tensor-core kernel) apart, as built and with one piece of work removed at a
time.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.bwd_ablation \
        [--matmul-dtype float32|bfloat16] [--periodic]

The inputs are one training batch of the flagship (784 -> ALIF-128
recurrent, learn_beta, T=100, batch 8192, init weights from seed 0, random
pixels) with the residuals of ``fused_head_fwd_train``.  Each variant is
the source, headers inlined, with one statement replaced (removing work changes the
gradients, so only the times mean anything).  Prints one JSON line per
variant: device milliseconds per launch of each function (median of 5
launches, ``torch.profiler``), then the card's name and power limit.
Builds go to ``.torch_ext_build/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from .. import LayerType, SNNConfig
from ..models import snn as model_lib
from ..ops import _build, fused
from ..ops.cells import masked_recurrent
from ..ops.encoding import pixels_to_firing_periods

VARIANTS = {  # name -> (statement of the kernel's source, its replacement)
    "no_rec_sums": ("if ((m >> i) & 1u) acc[i] += d;",
                    "if (i == 0) acc[0] += d;"),
    "no_mask_reads": ("s_bm[i] = brow[i];",
                      "s_bm[i] = 0x55555555u << (i & 1);"),
    "no_dcur_reads": ("const uint4 v = q[i];",
                      "const uint4 v = make_uint4(i, i, i, i);"),
    "no_out_sums": ("if ((zw[t * HW] >> (h & 31)) & 1u) sum += s_sr[t * O + o];",
                    "if (t == 0) sum += s_sr[o];"),
    "no_period_table": ("int t = p;", "int t = T; sum = col[p * HP];"),
    "no_gather": ("if (k >= 0) acc[i] += s_S[k * HP + h];",
                  "if (k == i) acc[i] += s_S[h];"),
    "no_chain_rec_product": (
        "mma_split_a<P>(rec[n], da, s_wrec, kk * (HP / 8) + MMA_NT * wu + n,\n"
        "                         lane);",
        "rec[n][0] += 0.f;"),
    "no_chain_out_product": (
        "mma_split_a<P>(dz[n], sa, s_wout, MMA_NT * wu + n, lane);",
        "dz[n][0] += 0.f;"),
}
FUNCTIONS = ("bwd_chain", "bwd_gwin", "bwd_gbits", "bwd_gout")


def _variant_lib(name: str, source: str) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"bwd_{name}.cu", out_dir / f"libbwd_{name}.so"
    cu.write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--periodic", action="store_true")
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

    def run():
        fused._head_bwd_cuda(g_logits, None, tstar, delta, None, lat, w_in,
                             w_rec, p0["beta"], w_out, 100, ns.periodic,
                             lcfg.alpha, lcfg.threshold, lcfg.gamma,
                             rcfg.kappa, lcfg.spike_func)

    source = _build.inlined_source("fused_head_bwd")
    libs = {"kernel": _build.load("fused_head_bwd")}
    for name, (old, new) in VARIANTS.items():
        if source.count(old) != 1:
            raise SystemExit(f"{name}: statement not found once in the "
                             "source")
        libs[name] = _variant_lib(name, source.replace(old, new))
    try:
        for name, lib in libs.items():
            _build._libs["fused_head_bwd"] = lib  # what fused._lib() loads
            print(json.dumps({"variant": name, "ms": _function_ms(run)}),
                  flush=True)
    finally:
        _build._libs["fused_head_bwd"] = libs["kernel"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
