"""Where the encoded product's time goes: time ``encode_matmul_fwd`` and
``encode_matmul_bwd`` (``csrc/encode_matmul.cu``) as built and with one
piece of work removed at a time, beside a plain ``zero_()`` of a tensor the
size of the currents (the card's write rate on that many bytes).

Run on a CUDA card from the repository root::

    python3 -m snnimageclassification_tpu_torch.tools.encode_ablation \
        [--matmul-dtype float32|bfloat16] [--batch 8192]

The inputs are the wide network's first layer (784 -> 512, T = 100) on one
batch of random pixels at the production tau (quirk Q2: every latency 0 or
t_max), TTFS and periodic, a random cotangent.  Each variant is the source,
headers inlined, with statements replaced (removing work changes the
results, so only the times mean anything).  Prints one JSON line per
variant: milliseconds per call of each wrapper (CUDA events, median of 10;
the forward's includes ``encode_sort``, the backward's ``encode_keys`` and
the slab sum), then the card's name and power limit.  Builds go to
``.torch_ext_build/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import _build, encode
from ..ops.encoding import pixels_to_firing_periods

VARIANTS = {  # name -> [(statement of the kernel's source, its replacement)]
    # Forward: the sums without the stores of the currents, and the stores
    # without the sums.
    "no_stores": [("if (live) o[t * step] = acc;",
                   "if (live && acc == 1234.5f) o[t * step] = acc;")],
    "stores_only": [
        ("acc = run_sum(wb, ws, list, start[t], start[t + 1]);", "acc = 0.f;"),
        ("every = run_sum(wb, ws, list, start[1], start[2]);", "every = 0.f;"),
        ("S[q] = run_sum(wb, ws, list, start[p], start[p + 1]);",
         "S[q] = 0.f;")],
    # Backward: the stream of stages and the period tables without the
    # gathers, and the period tables without their sums.
    "no_gather": [("    for (int r = 0; r < R; ++r) {\n      const uint4* kq",
                   "    for (int r = 0; r < 0; ++r) {\n      const uint4* kq")],
    "no_period_sums": [("p == 0 ? col[0] : period_sum(col, R * 32, p, T);",
                        "col[p * R * 32];")],
}


def _variant_lib(name: str, source: str) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"encode_{name}.cu", out_dir / f"libencode_{name}.so"
    cu.write_text(source)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ms(fn, n: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``n`` calls, by CUDA events."""
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=8192)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("encode_ablation needs a CUDA card")
    md = getattr(torch, ns.matmul_dtype)
    B, F, H, T = ns.batch, 784, 512, 100
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, size=(B, F)).astype(
        np.float32) / 255).cuda()
    lat = pixels_to_firing_periods(x, t_max=float(T)).contiguous()
    w = (0.05 * torch.randn(F, H, device="cuda")).to(md)
    g = torch.randn(T, B, H, device="cuda")
    buf = torch.empty(T, B, H, device="cuda")
    print(json.dumps({"variant": "zero_() of the currents' bytes",
                      "ms": _ms(buf.zero_)}), flush=True)
    del buf

    source = _build.inlined_source("encode_matmul")
    libs = {"kernel": _build.load("encode_matmul")}
    for name, edits in VARIANTS.items():
        src = source
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: statement not found in the source")
            src = src.replace(old, new)
        libs[name] = _variant_lib(name, src)
    try:
        for name, lib in libs.items():
            _build._libs["encode_matmul"] = lib  # what encode._lib() loads
            row = {"variant": name}
            for per in (False, True):
                tag = "periodic" if per else "ttfs"
                row[f"fwd_{tag}"] = _ms(
                    lambda: encode._fwd_cuda(lat, w, T, per))
                row[f"bwd_{tag}"] = _ms(
                    lambda: encode._bwd_cuda(lat, g, md, T, per))
            print(json.dumps(row), flush=True)
    finally:
        _build._libs["encode_matmul"] = libs["kernel"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
