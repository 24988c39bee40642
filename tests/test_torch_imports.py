"""The PyTorch port stands alone: no file of it, nor chip_smoke.py,
imports JAX or the JAX package (its own jax-free modules included)."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "snnimageclassification_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "snnimageclassification_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert len(FILES) > 10
    names = {str(p.relative_to(PORT)) for p in FILES[:-1]}
    assert {"train/__init__.py", "train/losses.py", "train/trainer.py",
            "ops/fused.py", "ops/fused_mid.py", "ops/fused2.py",
            "ops/encode.py", "ops/rec_scan.py", "ops/scan.py",
            "models/convert.py", "tools/train_profile.py",
            "parallel/ensemble.py", "train/checkpoint.py",
            "data/datasets.py", "data/device_cache.py",
            "utils/history.py", "utils/dict_utils.py"} <= names
    for src in ("fused_head.cu", "fused_head_bwd.cu", "fused_layer0_bwd.cu",
                "fused_mid.cu", "fused_mid_bwd.cu", "fused2.cu",
                "fused2_bwd.cu", "encode_matmul.cu", "rec_scan.cu",
                "scan.cu", "head_common.cuh", "lif_cell.cuh", "bwd_common.cuh"):
        assert (PORT / "csrc" / src).exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_tells_names_apart():
    assert _forbidden("jax.numpy")
    assert _forbidden("snnimageclassification_tpu")
    assert _forbidden("snnimageclassification_tpu.ops.cells")
    assert not _forbidden("snnimageclassification_tpu_torch")
    assert not _forbidden("snnimageclassification_tpu_torch.ops")
    assert not _forbidden("jaxlike")


def _ablation_variants():
    from snnimageclassification_tpu_torch.tools import (
        bwd_ablation,
        head_ablation,
    )
    return [(src, name, old)
            for src, mod in (("fused_head_bwd", bwd_ablation),
                             ("fused_head", head_ablation))
            for name, (old, _) in mod.VARIANTS.items()]


@pytest.mark.parametrize("source,name,statement", _ablation_variants(),
                         ids=lambda v: v if " " not in str(v) else "stmt")
def test_ablation_statements_exist_in_the_sources(source, name, statement):
    """The ablation tools replace one statement of a kernel's source (its
    headers inlined); a statement that moved or changed must be found
    again, exactly once."""
    from snnimageclassification_tpu_torch.ops import _build

    text = _build.inlined_source(source)
    assert '#include "' not in text and "#pragma once" not in text
    assert text.count(statement) == 1, f"{source} {name}"
