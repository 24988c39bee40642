"""Where the head pair's two bodies part on phase 22's ``fit``
(``chip_smoke.py``; ``tools/fit_check.py`` rates it over many seeds).

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.spike_parting \
        --seeds 2,10 [--data-seed 0] [--lr 1e-3] [--epochs 3]

Each seed's flagship (784 -> ALIF-128 recurrent, learn_beta, T = 100,
float32, TTFS) is trained by two ``Trainer`` s from the same init on the
same batches of ``get_dataloaders(DatasetId.MNIST, batch_size=32,
seed=--data-seed)`` (the synthetic set where no MNIST files exist), one on
the tensor-core body of the head pair, one on its per-unit body
(``fit_check.py``'s build: the body's shape test made false).  Before each
step both trainers' training forwards run on the batch; the first step
where their spikes differ is reported, with:

* ``params_part_step``: the first step after which the two trainers'
  parameters differ in any bit;
* ``same_params_spikes_part``: whether the per-unit body, given the
  tensor-core trainer's parameters at that step, fires other spikes than
  the tensor-core body (the forward's arithmetic parts them) or the same
  (only the parameters, that is the backward's sums, part them);
* where the forward parts them, the first (row, step, unit) whose spike
  differs, its residual on both bodies, and whether that row took the
  dense input product at a step up to then (TTFS: at least F / 16 features
  firing at one step) -- the operation the bodies sum in other orders.

Prints one JSON line per seed, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .. import EncodeConfig, LayerType, SNNConfig
from ..data import DatasetId, get_dataloaders
from ..ops import _build, fused
from ..ops.cells import masked_recurrent
from ..ops.encoding import pixels_to_firing_periods
from ..train import Trainer
from .fit_check import PER_UNIT, _per_unit_lib


def _forward(cfg, params, lat, libs):
    """The training forward on ``libs``'s build: (delta (T, B, H), its
    spikes)."""
    _build._libs.update(libs)
    p0, ro = params["input"], params["readout"]
    (_, lcfg), (_, rcfg) = cfg.layer_configs
    res = fused._head_train_cuda(
        lat, p0["w_in"].detach().contiguous(),
        masked_recurrent(lcfg, p0).detach().contiguous(),
        p0["beta"].detach(), ro["w_in"].detach().contiguous(),
        ro["b"].detach().contiguous(), cfg.int_time_steps, False, True,
        lcfg.alpha, lcfg.rho, lcfg.threshold, rcfg.kappa, True, False,
        False)
    return res[1], res[1] >= 0


def _same(a, b) -> bool:
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def part(seed, data_seed, lr, epochs, mma, per_unit):
    cfg = SNNConfig(input_size=784, output_size=10, n_hidden_neurons=128,
                    hidden_layer_type=LayerType.ALIF, learn_beta=True,
                    int_time_steps=100)
    enc = EncodeConfig(n_steps=100)
    dl = get_dataloaders(DatasetId.MNIST, batch_size=32, seed=data_seed)
    trainers = {name: Trainer(cfg, seed=seed, lr=lr, encode_config=enc,
                              device="cuda")
                for name in ("mma", "per-unit")}
    libs = {"mma": mma, "per-unit": per_unit}
    step, params_part = 0, None
    for _ in range(epochs):
        for batch in dl["train"]:
            x = torch.as_tensor(batch[0], dtype=torch.float32, device="cuda")
            lat = pixels_to_firing_periods(
                x, t_max=100.0, tau=enc.tau, thr=enc.thr,
                epsilon=enc.epsilon).contiguous()
            out = {n: _forward(cfg, t.params, lat, libs[n])
                   for n, t in trainers.items()}
            if not torch.equal(out["mma"][1], out["per-unit"][1]):
                d_same, z_same = _forward(cfg, trainers["mma"].params, lat,
                                          per_unit)
                d_mma, z_mma = out["mma"]
                found = {"seed": seed, "data_seed": data_seed,
                         "spikes_part_step": step,
                         "params_part_step": params_part,
                         "same_params_spikes_part":
                             not torch.equal(z_same, z_mma)}
                if found["same_params_spikes_part"]:
                    diff = (z_same != z_mma).nonzero()
                    t, b, h = (int(v) for v in diff[diff[:, 0].argmin()])
                    fires = (lat[b][None, :] == torch.arange(
                        t + 1, device=lat.device)[:, None]).sum(1)
                    found.update(
                        first_spike_flip={"step_t": t, "row": b, "unit": h},
                        residual_mma=float(d_mma[t, b, h]),
                        residual_per_unit=float(d_same[t, b, h]),
                        flips_in_batch=int(diff.shape[0]),
                        dense_input_steps=[
                            s for s, n in enumerate(fires.tolist())
                            if 16 * n >= lat.shape[1]])
                _build._libs.update(mma)
                return found
            for n, t in trainers.items():
                _build._libs.update(libs[n])
                t.train_step(batch[0], batch[1])
            if params_part is None and not _same(
                    trainers["mma"].params, trainers["per-unit"].params):
                params_part = step
            step += 1
    _build._libs.update(mma)
    return {"seed": seed, "data_seed": data_seed, "spikes_part_step": None,
            "params_part_step": params_part, "steps": step}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="2,10")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=3)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spike_parting needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    mma = {n: _build.load(n) for n in PER_UNIT}
    per_unit = {n: _per_unit_lib(n) for n in PER_UNIT}
    for seed in (int(s) for s in ns.seeds.split(",")):
        print(json.dumps(part(seed, ns.data_seed, ns.lr, ns.epochs, mma,
                              per_unit)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
