"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`; the
wrappers pass ``tensor.data_ptr()`` and PyTorch's current stream.  A build
happens at first use, never at import, into ``.torch_ext_build/`` beside
the package (listed in ``.gitignore``), keyed by a hash of the source, the
headers in ``csrc/`` and the flags, so an edited source rebuilds and an
unchanged one loads.
A failed build raises :class:`KernelBuildError`; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict

__all__ = ["BUILD_DIR", "KernelBuildError", "SOURCES", "build", "load",
           "build_log", "inlined_source"]

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
# Every kernel source of the port, one shared library each.
SOURCES = ("fused_head", "fused_head_bwd", "fused_layer0_bwd", "fused_mid",
           "fused_mid_bwd", "fused2", "fused2_bwd", "fused_izh",
           "fused_izh_bwd", "izh_scan", "encode_matmul", "rec_scan", "scan",
           "gbits")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
# --fmad=false: the kernels round a*b+c twice, as PyTorch's separate
# elementwise ops do, so they agree with their plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
    "-I", str(_CSRC),
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def inlined_source(name: str) -> str:
    """``csrc/<name>.cu`` with its ``#include "x.cuh"`` lines replaced by
    the headers' text (each once, as ``#pragma once`` has it): one
    self-contained source, for tools that build a variant of a kernel with
    a statement replaced wherever it lives."""
    seen = set()

    def expand(path: pathlib.Path) -> str:
        out = []
        for line in path.read_text().splitlines(keepends=True):
            m = re.match(r'\s*#include\s+"([^"]+\.cuh)"', line)
            if not m:
                if line.strip() != "#pragma once":
                    out.append(line)
                continue
            if m.group(1) not in seen:
                seen.add(m.group(1))
                out.append(expand(_CSRC / m.group(1)))
        return "".join(out)

    return expand(_CSRC / f"{name}.cu")


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; returns
    the shared library's path."""
    src = _CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    build_log[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
