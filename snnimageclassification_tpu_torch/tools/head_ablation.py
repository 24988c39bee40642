"""Where the head kernel's time goes: time ``csrc/fused_head.cu`` with one
phase removed at a time, on the served flagship batch.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.head_ablation

Each variant is the kernel source with one statement replaced (the readout
sum, the recurrent sum, or the per-step spike compaction); variants that
remove work change the dynamics, so only their times mean anything.  The
batch is the one ``chip_smoke.py`` serves: 4096 random uint8 rows of the
flagship (784 -> ALIF-128 recurrent, learn_beta, T=100, TTFS, production
tau), float32 weights.  Prints one JSON line per variant and round
(median of 20 launches by CUDA events) and the card's name and power
limit.  Builds go to ``.torch_ext_build/ablation/``.
"""
from __future__ import annotations

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
    "no_readout": (
        "const float r = masked_sum(zmask, nw, s_wout + o, O) + s_b[o];",
        "const float r = s_b[o];"),
    "no_recurrent_sum": (
        "const float cur = REC ? cin + masked_sum(zr, HW, s_wrec + h, H) "
        ": cin;",
        "const float cur = cin;"),
    "no_compaction": (
        "return fires(L, t, T, periodic) && !(every_step && L <= 1);",
        "return t == 0 && L == 0;"),
}


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("head_ablation needs a CUDA card")
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=100)
    params = model_lib.init(cfg, torch.Generator().manual_seed(0),
                            device="cuda")
    raw = np.random.default_rng(1).integers(0, 256, (4096, 784),
                                            dtype=np.uint8)
    x = torch.from_numpy(raw).cuda().to(torch.float32) / 255.0
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    p0, pr = params["input"], params["readout"]
    args = dict(
        latencies=pixels_to_firing_periods(x, t_max=100.0).contiguous(),
        w_in=p0["w_in"].contiguous(),
        w_rec=masked_recurrent(lcfg, p0).contiguous(), beta=p0["beta"],
        w_out=pr["w_in"].contiguous(), b_out=pr["b"].contiguous(),
        n_steps=100, use_periods=False, alif=True, alpha=lcfg.alpha,
        rho=lcfg.rho, threshold=lcfg.threshold, gamma=lcfg.gamma,
        kappa=rcfg.kappa)
    source = _build.inlined_source("fused_head")
    libs = {"kernel": _build.load("fused_head")}
    for name, (old, new) in VARIANTS.items():
        if old not in source:
            raise SystemExit(f"{name}: statement not found in fused_head.cu")
        libs[name] = _variant_lib(name, source.replace(old, new))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    try:
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


if __name__ == "__main__":
    main()
