"""Where a training step's time goes: profile ``Trainer.train_step`` on the
flagship (784 -> ALIF-128 recurrent, learn_beta, T=100) or, with ``--deep``,
on the deep network 784 -> 128 -> 128 -> 96 -> 10 (same cell), with
``--twolayer`` on 784 -> 128 -> 128 -> 10 (``bench.py``'s twolayer leg, one
kernel pair: ``fused2``), with ``--wide`` on 784 -> ALIF-512 -> 10 (the
unfused tier: ``encode_matmul``, ``rec_scan`` and the readout's per-step
loop), with ``--ff`` on 784 -> ALIF-256 -> 10 feedforward with
constant-pixel input (``as_timeseries=False``: one product on the pixels
repeated over T, the feedforward ``scan`` and the readout's per-step loop;
with ``--periodic`` its own periodic encoding instead), at batch 8192 on
the synthetic prototype task ``chip_smoke.py`` trains.  ``--izh`` takes
the Izhikevich cell instead (784 -> Izhikevich-128 recurrent -> 10, with
``--deep`` 784 -> 128 -> 128 -> 10, dt = 30 where units fire), and
``--loop`` the per-step time loop (``use_kernels=False``) instead of the
kernels.  ``--ensemble`` profiles ``EnsembleTrainer.train_step`` on six
seeds of the single-hidden-layer network instead (the default unrolled
single kernel pairs; ``--stacked`` one stacked pair a step;
``--izh`` the Izhikevich net).

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.train_profile \
        [--deep | --twolayer | --wide | --ff | --ensemble [--stacked]] \
        [--izh] [--loop] [--matmul-dtype float32|bfloat16] \
        [--periodic] [--steps 10]

After 3 warm-up steps it traces ``--steps`` steps with ``torch.profiler``
(CPU and CUDA activities) and prints one JSON line: the step's wall time
(host clock around the traced steps, ending in a synchronize, so it
includes the profiler's own cost), the device time per step of every
device kernel by name (the ``__global__`` functions of a backward kernel
appear apart, each template instance under its own name: the chain of the
head mode is ``bwd_chain_kernel<.., true, ..>``, of a z-emitting layer
``<.., false, ..>``; ``bwd_gbits_kernel`` sums its ``g_W_rec`` and ``g_W_in``
launches), the device's busy and idle share of the window, and the card's
name and power limit.  ``port_kernels_ms_per_step`` sums the kernels of
``csrc/``; ``other_kernels_ms_per_step`` is PyTorch's own (with ``--wide``
mostly the readout's per-step loop, forward and backward; with ``--ff``
also the input product and its ``g_W``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import EncodeConfig, LayerType, SNNConfig
from ..parallel import EnsembleTrainer
from ..train import Trainer

BATCH = 8192
SEEDS = 6  # the ensemble scripts' seed count


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--deep", action="store_true",
                    help="three hidden layers (128, 128, 96); with --izh two "
                         "(128, 128)")
    ap.add_argument("--twolayer", action="store_true",
                    help="two hidden layers (128, 128), the fused2 pair")
    ap.add_argument("--wide", action="store_true",
                    help="one hidden layer of 512 (the unfused tier)")
    ap.add_argument("--ff", action="store_true",
                    help="one feedforward ALIF layer of 256 on constant-pixel "
                         "input (the feedforward scan)")
    ap.add_argument("--izh", action="store_true",
                    help="Izhikevich layers at dt=30")
    ap.add_argument("--loop", action="store_true",
                    help="use_kernels=False: the per-step time loop")
    ap.add_argument("--ensemble", action="store_true",
                    help=f"EnsembleTrainer on {SEEDS} seeds")
    ap.add_argument("--stacked", action="store_true",
                    help="with --ensemble: fused_replicas='stacked'")
    ap.add_argument("--steps", type=int, default=10)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA card")
    if sum((ns.twolayer, ns.wide, ns.ff, ns.deep or ns.izh)) > 1:
        raise SystemExit("--twolayer, --wide and --ff are ALIF networks of "
                         "their own")
    if ns.ensemble and (ns.twolayer or ns.wide or ns.ff or ns.deep):
        raise SystemExit("--ensemble takes the single-hidden-layer network")
    if ns.stacked and not ns.ensemble:
        raise SystemExit("--stacked needs --ensemble")
    if ns.ff:
        cell = dict(hidden_layer_type=LayerType.ALIF, n_hidden_neurons=256,
                    use_recurrent_connection=False)
    elif ns.izh:
        cell = dict(hidden_layer_type=LayerType.Izhikevich, dt=30.0,
                    n_hidden_neurons=[128, 128] if ns.deep else 128)
    else:
        widths = ([128, 128, 96] if ns.deep else [128, 128] if ns.twolayer
                  else 512 if ns.wide else 128)
        cell = dict(hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    n_hidden_neurons=widths)
    cfg = SNNConfig(input_size=784, output_size=10, int_time_steps=100,
                    matmul_dtype=ns.matmul_dtype, use_kernels=not ns.loop,
                    **cell)
    enc = EncodeConfig(n_steps=100, use_periods=ns.periodic,
                       as_timeseries=not ns.ff or ns.periodic)
    if ns.ensemble:
        ens = EnsembleTrainer(cfg, seeds=range(SEEDS), device="cuda",
                              fused_replicas="stacked" if ns.stacked
                              else None)

        def step(x, y):
            return ens.train_step(x, y, encode_config=enc)
    else:
        step = Trainer(cfg, seed=0, encode_config=enc,
                       device="cuda").train_step
    rng = np.random.default_rng(3)
    protos = rng.random((10, 784), dtype=np.float32)
    y = rng.integers(0, 10, BATCH)
    x = np.clip(protos[y] + 0.15 * rng.standard_normal(
        (BATCH, 784), dtype=np.float32), 0.0, 1.0)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    for _ in range(3):
        step(x, y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ns.steps):
            step(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us
    busy_ms = sum(kernels.values()) / 1e3 / ns.steps
    # The port's kernels live in anonymous namespaces of csrc/; PyTorch's
    # (cuBLAS, elementwise, reductions, Adam) make up the rest.
    port_ms = sum(v for k, v in kernels.items()
                  if "(anonymous namespace)::" in k and "at::" not in k
                  ) / 1e3 / ns.steps
    step_ms = wall / ns.steps * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "deep": ns.deep, "twolayer": ns.twolayer, "wide": ns.wide,
        "ff": ns.ff, "izh": ns.izh,
        "ensemble_seeds": SEEDS if ns.ensemble else None,
        "stacked": ns.stacked,
        "loop": ns.loop,
        "matmul_dtype": ns.matmul_dtype,
        "periodic": ns.periodic,
        "steps": ns.steps, "step_ms_wall_traced": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "port_kernels_ms_per_step": port_ms,
        "other_kernels_ms_per_step": busy_ms - port_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "kernel_ms_per_step": {k[:90]: v / 1e3 / ns.steps for k, v in top},
        "card": card,
    }))


if __name__ == "__main__":
    main()
