"""Phase 22's ``fit`` gate of ``chip_smoke.py`` on four paths: the head
pair's tensor-core body (as built), its per-unit body, the raster path
(``EnsembleTrainer(fused_replicas=False)``: ``forward_logits`` on the
encoded raster, the recurrent layer through ``rec_scan``, no head kernel) and
the plain per-step loop (``use_kernels=False``: no kernel at all).

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.fit_check \
        [--periodic] [--lr 1e-3] [--paths mma,per-unit,raster,plain] \
        [--seeds 6] [--data-seed 0]

Each path fits ``--seeds`` flagship seeds (784 -> ALIF-128 recurrent,
learn_beta, T = 100, float32; seeds 0, 1, ...) for 3 epochs on
``get_dataloaders(DatasetId.MNIST, seed=--data-seed)`` (the synthetic set
where no MNIST files exist; the data seed draws the split and the
shuffles) at batch 32, TTFS or with ``--periodic`` the periodic encoding,
at learning rate ``--lr``.  A replica's trajectory does not depend on the
other seeds in its ensemble, so seeds 0-5 of a larger run are the six of
``chip_smoke.py``'s fit.  The per-unit body is the kernel sources with the
tensor-core body's shape test made false (the per-unit body then takes
every shape).  Prints one JSON line per path: the seeds whose validation
loss (and training loss) did not fall from the first epoch to the third,
for each group of six seeds whether the group's mean validation loss fell,
the ensemble's test accuracy, the fit's seconds and each seed's losses by
epoch; then the card's name and power limit.  The paths' losses part in
their last bits from the first step on, so where training is unstable a
seed can pass on one path and fail on another.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
import time

import torch

from .. import LayerType, SNNConfig
from ..data import DatasetId, get_dataloaders
from ..ops import _build
from ..parallel import EnsembleTrainer

# The tensor-core bodies' shape tests (csrc/head_mma_fwd.cuh,
# csrc/chain_mma.cuh), and the same made false.
_FWD_TEST = (
    "inline bool mma_fits(int H, int O, int rec, int bf16, int max_smem) "
    "{\n  return O >= 0",
    "inline bool mma_fits(int H, int O, int rec, int bf16, int max_smem) "
    "{\n  return false && O >= 0")
_CHAIN_TEST = (
    "inline bool chain_mma_fits(int H, int O, int rec, int bf16, "
    "int max_smem) {\n  return O >= 0",
    "inline bool chain_mma_fits(int H, int O, int rec, int bf16, "
    "int max_smem) {\n  return false && O >= 0")
# source -> its shape test: the LIF/ALIF head pair and the Izhikevich one.
SHAPE_TESTS = {"fused_head": _FWD_TEST, "fused_head_bwd": _CHAIN_TEST,
               "fused_izh": _FWD_TEST, "fused_izh_bwd": _CHAIN_TEST}
PER_UNIT = ("fused_head", "fused_head_bwd")  # the pair the fits train


def _per_unit_lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with its tensor-core body's shape test made
    false: every shape runs the per-unit body."""
    old, new = SHAPE_TESTS[name]
    source = _build.inlined_source(name)
    if source.count(old) != 1:
        raise SystemExit(f"{name}: the shape test is not found once")
    out_dir = _build.BUILD_DIR / "fit_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(source.replace(old, new))
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--paths", default="mma,per-unit,raster,plain")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--data-seed", type=int, default=0)
    ns = ap.parse_args()
    periodic = ns.periodic
    if not torch.cuda.is_available():
        raise SystemExit("fit_check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(input_size=784, output_size=10, n_hidden_neurons=128,
               hidden_layer_type=LayerType.ALIF, learn_beta=True,
               int_time_steps=100)
    built = {n: _build.load(n) for n in PER_UNIT}
    paths = {"mma": (built, "stacked", True),
             "per-unit": (None, "stacked", True),
             "raster": (built, False, True),
             "plain": (built, False, False)}
    try:
        for path in ns.paths.split(","):
            libs, fused_replicas, use_kernels = paths[path]
            if libs is None:
                libs = {n: _per_unit_lib(n) for n in PER_UNIT}
            _build._libs.update(libs)  # what the wrappers load
            with tempfile.TemporaryDirectory() as tmp:
                dl = get_dataloaders(DatasetId.MNIST, batch_size=32,
                                     seed=ns.data_seed,
                                     to_spikes_use_periods=periodic)
                ens = EnsembleTrainer(SNNConfig(**cfg, use_kernels=use_kernels),
                                      seeds=range(ns.seeds), lr=ns.lr,
                                      fused_replicas=fused_replicas,
                                      checkpoint_folder=tmp, device="cuda")
                t0 = time.perf_counter()
                hist = ens.fit(dl["train"], dl["val"], 3, verbose=False)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                acc = ens.ensemble_accuracy(dl["test"])
            val_rose = [s for s, h in enumerate(hist)
                        if not h["val"][-1] < h["val"][0]]
            train_rose = [s for s, h in enumerate(hist)
                          if not h["train"][-1] < h["train"][0]]
            mean_val_fell = [
                sum(h["val"][-1] for h in hist[g:g + 6])
                < sum(h["val"][0] for h in hist[g:g + 6])
                for g in range(0, len(hist) - 5, 6)]
            print(json.dumps({
                "path": path, "periodic": periodic, "lr": ns.lr,
                "data_seed": ns.data_seed, "seeds": ns.seeds,
                "val_did_not_fall": val_rose,
                "train_did_not_fall": train_rose,
                "mean_val_fell_by_six": mean_val_fell,
                "ensemble_accuracy": acc, "seconds": round(seconds, 1),
                "train": [[round(v, 4) for v in h["train"]] for h in hist],
                "val": [[round(v, 4) for v in h["val"]] for h in hist]}),
                flush=True)
    finally:
        _build._libs.update(built)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
