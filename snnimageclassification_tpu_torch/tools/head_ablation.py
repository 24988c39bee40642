"""Where the head kernel's time goes: time ``csrc/fused_head.cu`` with one
phase removed at a time, on the served flagship batch.

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.head_ablation
    python3 -m snnimageclassification_tpu_torch.tools.head_ablation \
        --launch-order

Each variant is the kernel source with one statement replaced (the readout
sum, the recurrent sum, or the per-step spike compaction); variants that
remove work change the dynamics, so only their times mean anything.  The
batch is the one ``chip_smoke.py`` serves: 4096 random uint8 rows of the
flagship (784 -> ALIF-128 recurrent, learn_beta, T=100, TTFS, production
tau), float32 weights.  Prints one JSON line per variant and round
(median of 20 launches by CUDA events) and the card's name and power
limit.  Builds go to ``.torch_ext_build/ablation/``.

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

# The stacked launch with its grid's axes swapped: replicas on x (fastest),
# row tiles on y.
LAUNCH_ORDER = (
    ("const int tile = blockIdx.x;", "const int tile = blockIdx.y;"),
    ("at_replica<W>(a0, blockIdx.y);", "at_replica<W>(a0, blockIdx.x);"),
    ("dim3 grid(tiles, S);", "dim3 grid(S, tiles);"),
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
                             "fused_head.cu")
        source = source.replace(old, new)
    return source


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launch-order", action="store_true",
                        help="time the stacked kernel's two grid orders")
    launch_order = parser.parse_args().launch_order
    if not torch.cuda.is_available():
        raise SystemExit("head_ablation needs a CUDA card")
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
    source = _build.inlined_source("fused_head")
    libs = {"kernel": _build.load("fused_head")}
    variants = ({"replica_fastest": LAUNCH_ORDER} if launch_order
                else {k: (v,) for k, v in VARIANTS.items()})
    for name, pairs in variants.items():
        libs[name] = _variant_lib(name, _replace(name, source, pairs))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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


if __name__ == "__main__":
    main()
