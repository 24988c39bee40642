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
            "ops/fused.py", "models/convert.py"} <= names
    for src in ("fused_head.cu", "fused_head_bwd.cu", "head_common.cuh"):
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
