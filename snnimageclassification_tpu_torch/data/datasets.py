"""Datasets and array loaders.

The port's own copy of the JAX package's data/datasets.py.  The reference
builds torchvision datasets with a per-sample CPU transform stack
(``src/datasets/datasets.py:100-152``); here, as in the JAX package:

* datasets are loaded **once** into host numpy arrays (raw pixels,
  float32 in [0, 1], flattened);
* loaders yield raw pixel batches and carry an :class:`EncodeConfig`
  describing the spike encoding, which the model applies **on the device**
  (the head kernels take latencies; ``train.encode_on_device`` builds a
  raster where a path needs one);
* the host never touches a spike train.

MNIST / Fashion-MNIST are read from local IDX or npz files (there is no
download).  A deterministic synthetic dataset with the same shapes is the
explicit, loudly warned fallback (``source="synthetic"``), so tests and the
card's smoke run work anywhere.  Batch order comes from
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
packages' loaders yield the same batches index for index.
"""
from __future__ import annotations

import dataclasses
import enum
import gzip
import logging
import os
import pathlib
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "DatasetId",
    "EncodeConfig",
    "ArrayDataLoader",
    "load_raw",
    "get_dataloaders",
    "read_idx",
]

DATA_DIR_ENV = "SNN_TPU_DATA_DIR"


class DatasetId(enum.Enum):
    """Mirror of the reference's DatasetId enum (datasets.py:11-13), plus
    DIGITS: scikit-learn's bundled 8x8 handwritten digits (real data that
    loads without files, where scikit-learn is installed)."""

    MNIST = enum.auto()
    FASHION_MNIST = enum.auto()
    DIGITS = enum.auto()


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """How raw pixel batches become model inputs.

    ``as_timeseries=False`` feeds pixels as a constant-over-time input
    (the model repeats them across T, snn.py:159-171); otherwise the spike
    encoder runs on the device with these settings (defaults match
    ToSpikes, datasets.py:16-40, including quirk Q2's degenerate tau).
    """

    as_timeseries: bool = True
    n_steps: int = 100
    use_periods: bool = False
    tau: float = 20.0 * 1e-3
    thr: float = 0.2
    epsilon: float = 1e-7


# ---------------------------------------------------------------------------
# IDX / npz readers
# ---------------------------------------------------------------------------
def read_idx(path: os.PathLike) -> np.ndarray:
    """Parse an IDX-format file (optionally .gz), the MNIST wire format."""
    path = pathlib.Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        zero1, zero2, dtype_code, ndim = struct.unpack("BBBB", f.read(4))
        if zero1 != 0 or zero2 != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic)")
        dtype = {
            0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
            0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
        }.get(dtype_code)
        if dtype is None:
            raise ValueError(f"{path}: unknown IDX type code {dtype_code:#x}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(),
                             dtype=np.dtype(dtype).newbyteorder(">"))
        if data.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {data.size} values for shape {shape}")
        return data.reshape(shape).astype(dtype)


_IDX_NAMES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def _find_idx_file(folder: pathlib.Path, names: Tuple[str, ...]):
    for name in names:
        for candidate in (folder / name, folder / (name + ".gz")):
            if candidate.exists():
                return candidate
    return None


def _try_load_idx_folder(folder: pathlib.Path):
    files = {k: _find_idx_file(folder, names)
             for k, names in _IDX_NAMES.items()}
    if any(v is None for v in files.values()):
        return None
    return {k: read_idx(v) for k, v in files.items()}


def _try_load_npz(path: pathlib.Path):
    if not path.exists():
        return None
    with np.load(path) as z:
        if {"x_train", "y_train", "x_test", "y_test"} <= set(z.files):
            return {
                "train_images": z["x_train"], "train_labels": z["y_train"],
                "test_images": z["x_test"], "test_labels": z["y_test"],
            }
    return None


def _candidate_roots(data_dir: Optional[str]):
    """Where local files are looked for: ``data_dir``, ``$SNN_TPU_DATA_DIR``,
    ``data/datasets`` and ``data`` under the working directory, and the
    usual folders under ``$HOME``."""
    roots = []
    if data_dir:
        roots.append(pathlib.Path(data_dir))
    if os.environ.get(DATA_DIR_ENV):
        roots.append(pathlib.Path(os.environ[DATA_DIR_ENV]))
    home = pathlib.Path.home()
    roots += [
        pathlib.Path("data/datasets"),
        pathlib.Path("data"),
        home / ".keras" / "datasets",
        home / "data",
        home / "datasets",
    ]
    return roots


_DATASET_DIRS = {
    DatasetId.MNIST: ("mnist", "MNIST", "torch/mnist/MNIST/raw", "MNIST/raw"),
    DatasetId.FASHION_MNIST: (
        "fashion-mnist", "fashion_mnist", "FashionMNIST",
        "torch/fashion-mnist/FashionMNIST/raw", "FashionMNIST/raw",
    ),
}

_DATASET_NPZ = {
    DatasetId.MNIST: ("mnist.npz",),
    DatasetId.FASHION_MNIST: ("fashion_mnist.npz", "fashion-mnist.npz"),
}


def _make_synthetic(dataset_id: DatasetId, n_train: int, n_test: int,
                    side: int = 28):
    """Deterministic synthetic data (10 learnable classes) of ``side`` x
    ``side`` images: each class a smooth random prototype, samples the
    prototype plus pixel noise, clipped to [0, 1].  At ``side=28`` the JAX
    package's generator, value for value."""
    rng = np.random.default_rng(1234 + list(DatasetId).index(dataset_id))
    protos = rng.random((10, side, side)).astype(np.float32)
    # Smooth the prototypes a little so latency encodings differ per class.
    k = np.ones((3, 3), np.float32) / 9.0
    smooth = np.stack([_conv2d_same(p, k) for p in protos])

    def make(n, rng):
        y = rng.integers(0, 10, size=n).astype(np.int32)
        x = smooth[y] + 0.25 * rng.standard_normal(
            (n, side, side)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_train, y_train = make(n_train, rng)
    x_test, y_test = make(n_test, rng)
    return {
        "train_images": (x_train * 255).astype(np.uint8),
        "train_labels": y_train,
        "test_images": (x_test * 255).astype(np.uint8),
        "test_labels": y_test,
    }


def _conv2d_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    out = np.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            out += kernel[i, j] * padded[i:i + img.shape[0],
                                         j:j + img.shape[1]]
    return out


def _load_digits_raw() -> Optional[Dict[str, np.ndarray]]:
    """scikit-learn's bundled 8x8 digits, split 80/20 deterministically, or
    None where scikit-learn is not installed.  Pixel values 0..16 are
    rescaled to 0..255 uint8 so the shared normalization (/255) puts them
    in [0, 1] like MNIST."""
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    d = load_digits()
    x = (d.images.astype(np.float32) * (255.0 / 16.0)).astype(np.uint8)
    y = d.target.astype(np.int32)
    # Deterministic shuffle so the class order of the bundled file doesn't
    # leak into the train/test split.
    perm = np.random.default_rng(0).permutation(x.shape[0])
    x, y = x[perm], y[perm]
    n_test = x.shape[0] // 5
    return {
        "train_images": x[n_test:], "train_labels": y[n_test:],
        "test_images": x[:n_test], "test_labels": y[:n_test],
    }


def _synthetic_fallback(dataset_id, searched, n_train, n_test, side):
    # Result-integrity guard: a user asking for a dataset must not silently
    # train on synthetic data.  Loud warning + source="synthetic" on the
    # return dict and on every loader built from it.
    logger.warning(
        "No local data found for %s (searched %s); falling back to the "
        "SYNTHETIC dataset. Accuracies will NOT be comparable to "
        "published %s numbers. Drop IDX/npz files under $%s (or install "
        "scikit-learn for DIGITS) to use real data.",
        dataset_id.name, searched, dataset_id.name, DATA_DIR_ENV,
    )
    return _make_synthetic(dataset_id, n_train, n_test, side)


def load_raw(
    dataset_id: DatasetId,
    data_dir: Optional[str] = None,
    *,
    allow_synthetic: bool = True,
    synthetic_train: int = 4096,
    synthetic_test: int = 1024,
) -> Dict[str, np.ndarray]:
    """Load a dataset as flat float32 arrays in [0, 1].

    Returns ``{x_train (N, F), y_train (N,), x_test, y_test, source}``.
    Probes IDX folders and npz files under the roots of
    :func:`_candidate_roots`; DIGITS comes from scikit-learn.  Falls back
    to the deterministic synthetic dataset (28 x 28, 8 x 8 for DIGITS) when
    ``allow_synthetic``, else raises FileNotFoundError.
    """
    if dataset_id is DatasetId.DIGITS:
        raw = _load_digits_raw()
        if raw is not None:
            return _finalize_raw(raw, "sklearn:load_digits")
        if not allow_synthetic:
            raise FileNotFoundError(
                "DIGITS needs scikit-learn, which is not installed")
        return _finalize_raw(_synthetic_fallback(
            dataset_id, ["sklearn"], synthetic_train, synthetic_test, 8),
            "synthetic")
    raw = None
    source = None
    for root in _candidate_roots(data_dir):
        for sub in _DATASET_DIRS[dataset_id]:
            folder = root / sub
            if folder.is_dir():
                raw = _try_load_idx_folder(folder)
                if raw is not None:
                    source = str(folder)
                    break
        if raw is None:
            for npz_name in _DATASET_NPZ[dataset_id]:
                raw = _try_load_npz(root / npz_name)
                if raw is not None:
                    source = str(root / npz_name)
                    break
        if raw is not None:
            break

    if raw is None:
        searched = [str(r) for r in _candidate_roots(data_dir)]
        if not allow_synthetic:
            raise FileNotFoundError(
                f"No local files for {dataset_id}; searched {searched}. Set "
                f"${DATA_DIR_ENV} or pass data_dir, or allow_synthetic=True."
            )
        raw = _synthetic_fallback(dataset_id, searched, synthetic_train,
                                  synthetic_test, 28)
        source = "synthetic"
    return _finalize_raw(raw, source)


def _finalize_raw(raw: Dict[str, np.ndarray],
                  source: str) -> Dict[str, np.ndarray]:
    def flat(x):
        x = np.asarray(x)
        return (x.reshape(x.shape[0], -1).astype(np.float32)) / 255.0

    return {
        "x_train": flat(raw["train_images"]),
        "y_train": np.asarray(raw["train_labels"]).astype(np.int32),
        "x_test": flat(raw["test_images"]),
        "y_test": np.asarray(raw["test_labels"]).astype(np.int32),
        "source": source,
    }


# ---------------------------------------------------------------------------
# Array loader
# ---------------------------------------------------------------------------
class ArrayDataLoader:
    """Minimal epoch iterator over in-memory arrays.

    Yields ``(x (B, F) float32, y (B,) int32)`` numpy batches; re-shuffles
    every epoch when ``shuffle`` (like the reference's train DataLoader,
    datasets.py:143-145).  Carries the :class:`EncodeConfig` so the trainer
    knows how to map pixels to model inputs on the device.
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        encode_config: EncodeConfig = EncodeConfig(),
        source: Optional[str] = None,
    ):
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"{x.shape[0]} inputs but {y.shape[0]} labels")
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.encode_config = encode_config
        # Provenance: file path the arrays came from, or "synthetic".
        self.source = source
        self._rng = np.random.default_rng(seed)

    @property
    def n_samples(self) -> int:
        return self.x.shape[0]

    def __len__(self) -> int:
        n = self.n_samples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def iter_indices(self) -> Iterator[np.ndarray]:
        """Per-epoch batch index arrays (shuffled when configured): a
        consumer can gather the rows itself, e.g. on the device from a
        device-resident copy of the dataset (data/device_cache.py)."""
        idx = np.arange(self.n_samples)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (
            self.n_samples - self.n_samples % self.batch_size
            if self.drop_last
            else self.n_samples
        )
        for start in range(0, end, self.batch_size):
            yield idx[start:start + self.batch_size]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for sel in self.iter_indices():
            yield self.x[sel], self.y[sel]


def get_dataloaders(
    dataset_id: DatasetId,
    batch_size: int = 64,
    train_val_split_ratio: float = 0.85,
    as_timeseries: bool = True,
    n_steps: int = 100,
    to_spikes_use_periods: bool = False,
    nb_workers: int = 0,  # accepted for API parity; encoding is on-device
    *,
    seed: int = 0,
    data_dir: Optional[str] = None,
    allow_synthetic: bool = True,
    drop_last_train: bool = False,
) -> Dict[str, ArrayDataLoader]:
    """Train/val/test loaders with the reference's surface
    (datasets.py:100-152): random train/val split by ratio, shuffled train
    loader, sequential val/test loaders.

    Every loader carries ``loader.source`` -- the file path the arrays were
    read from, or ``"synthetic"`` for the (loudly warned) fallback.
    """
    del nb_workers  # host workers are unnecessary: encoding runs on device
    raw = load_raw(dataset_id, data_dir, allow_synthetic=allow_synthetic)
    enc = EncodeConfig(
        as_timeseries=as_timeseries,
        n_steps=n_steps,
        use_periods=to_spikes_use_periods,
    )
    n = raw["x_train"].shape[0]
    n_train = int(n * train_val_split_ratio)
    perm = np.random.default_rng(seed).permutation(n)
    tr, va = perm[:n_train], perm[n_train:]

    def mk(x, y, shuffle, drop_last=False, s=0):
        return ArrayDataLoader(
            x, y, batch_size, shuffle=shuffle, drop_last=drop_last,
            seed=seed + s, encode_config=enc, source=raw["source"],
        )

    return {
        "train": mk(raw["x_train"][tr], raw["y_train"][tr], True,
                    drop_last_train, 1),
        "val": mk(raw["x_train"][va], raw["y_train"][va], False, False, 2),
        "test": mk(raw["x_test"], raw["y_test"], False, False, 3),
    }
