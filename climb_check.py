"""Does the two-hidden-layer network's loss climb in the JAX trainer too?

Trains 784 -> ALIF-128 -> ALIF-128 -> 10 (recurrent, learn_beta, T = 100,
TTFS) with the JAX package's trainer and with the PyTorch port's, on the
CPU, from one init (the port's ``Trainer(seed=0)`` draw, carried to JAX as
numpy) and on the same batches of ``chip_smoke.py``'s prototype task (10
class prototypes plus 0.15 noise, numpy seed 3), at Adam lr 1e-3 with L2
1e-5, and prints both loss sequences as one JSON line.  ``--loop`` trains
the port through its per-step loop (``use_kernels=False``) instead of the
plain version of its two-layer kernel pair.

    JAX_PLATFORMS=cpu python climb_check.py [--batch 256] [--loop]

A one-off check, not a test: at B = 8192 on the card the port's loss
falls for 4-6 steps and then climbs at this lr.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import snnimageclassification_tpu as jst
from snnimageclassification_tpu.data.datasets import EncodeConfig as JEnc
from snnimageclassification_tpu.models import snn as jsnn
from snnimageclassification_tpu.train import trainer as jtrainer
import snnimageclassification_tpu_torch as tst
from snnimageclassification_tpu_torch.models.convert import params_to_numpy
from snnimageclassification_tpu_torch.train import trainer as ttrainer


def batches(n, batch, seed=3):
    rng = np.random.default_rng(seed)
    protos = rng.random((10, 784), dtype=np.float32)
    out = []
    for _ in range(n):
        y = rng.integers(0, 10, batch)
        x = np.clip(protos[y] + 0.15 * rng.standard_normal(
            (batch, 784), dtype=np.float32), 0.0, 1.0)
        out.append((x, y.astype(np.int32)))
    return out


LR = 1e-3
STEPS = 15


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--loop", action="store_true")
    ns = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    kw = dict(input_size=784, output_size=10, n_hidden_neurons=[128, 128],
              hidden_layer_type="ALIF", learn_beta=True, int_time_steps=100)
    jcfg, tcfg = jst.SNNConfig(**kw), tst.SNNConfig(**kw)
    if ns.loop:
        tcfg = dataclasses.replace(tcfg, use_kernels=False)
    enc = dict(n_steps=100)
    tt = ttrainer.Trainer(tcfg, seed=0, lr=LR, weight_decay=1e-5,
                          encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tt.params))
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=tempfile.mkdtemp())
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp), lr=LR,
                                 weight_decay=1e-5)
    step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    w = jnp.ones(ns.batch)
    data = batches(4, ns.batch)
    jl, tl = [], []
    t0 = time.perf_counter()
    for i in range(STEPS):
        x, y = data[i % len(data)]
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(x),
                                   jnp.asarray(y), w)
        jl.append(round(float(loss), 4))
        tl.append(round(float(tt.train_step(x, y)), 4))
    print(json.dumps({
        "net": "784-ALIF128-ALIF128-10", "batch": ns.batch, "lr": LR,
        "port_route": "loop" if ns.loop else "fused2_reference",
        "jax_losses": jl, "port_losses": tl,
        "seconds": round(time.perf_counter() - t0, 1), "device": "cpu"}))


if __name__ == "__main__":
    main()
